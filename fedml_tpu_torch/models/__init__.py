from .hub import create, init_params  # noqa: F401
