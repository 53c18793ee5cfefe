from .builtin import build_algorithm  # noqa: F401
# importing fedgan registers "FedGAN" in ALGORITHMS, as in the JAX package
from .fedgan import init_gan_params, make_fedgan  # noqa: F401
