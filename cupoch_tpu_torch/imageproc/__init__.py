"""Image processing pipelines (cupoch imageproc/): semi-global stereo
matching."""
from .sgm import SemiGlobalMatching, SGMOption, compute_disparity

__all__ = ["SemiGlobalMatching", "SGMOption", "compute_disparity"]
