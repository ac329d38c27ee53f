"""Small host helpers: paths, plotting (matplotlib imported inside the
plotting functions), timers that synchronise the card (the JAX package's
``utils`` names)."""
from .paths import get_package_dir, get_repo_dir, get_output_dir
from .plotting import plot_fr, plot_fr_radial, plot_fr_complex, png_matrix
from .timers import Timer, block_and_time

__all__ = [
    "get_package_dir",
    "get_repo_dir",
    "get_output_dir",
    "plot_fr",
    "plot_fr_radial",
    "plot_fr_complex",
    "png_matrix",
    "Timer",
    "block_and_time",
]
