"""prefill_ffn_us_per_tok: device time per prompt token of the program's
`ffn` spans (each layer's pre-norm, dense MLP or RWKV's channel mix, up to
the residual add)."""
from fedbench.yardstick import program_spans


def read(rec):
    return program_spans.per_token_us(rec, "ffn")
