"""The paper's own SemCom autoencoder (configured via repro_torch.semcom)."""
from repro_torch.semcom.autoencoder import AEConfig

CONFIG = AEConfig(image_size=32, channels=3, hidden=16, base_latent=8, rho=1.0)
