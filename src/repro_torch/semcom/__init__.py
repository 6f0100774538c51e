"""repro_torch.semcom: the paper's CNN autoencoder, shape-static
(`AEConfig.rho`) and runtime-rho (`forward_rho` family) codecs.

Counterpart of `repro.semcom`, with the same public names.
"""
from .autoencoder import (
    AEConfig, compressed_bits_rho, decode, decode_rho, encode, encode_rho,
    forward, forward_rho, init_params, latent_mask, mse_loss, mse_loss_rho,
    param_bits, proxy_accuracy, proxy_accuracy_rho, psnr,
)

__all__ = [
    "AEConfig", "init_params", "param_bits", "latent_mask",
    "encode", "decode", "forward", "mse_loss", "psnr", "proxy_accuracy",
    "encode_rho", "decode_rho", "forward_rho", "mse_loss_rho",
    "proxy_accuracy_rho", "compressed_bits_rho",
]
