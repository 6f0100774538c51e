"""prefill_mixer_us_per_tok: device time per prompt token of the program's
`mixer` spans (each layer's pre-norm, attention with flash or RWKV's time
mix with WKV6, up to the residual add)."""
from fedbench.yardstick import program_spans


def read(rec):
    return program_spans.per_token_us(rec, "mixer")
