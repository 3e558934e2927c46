from .constants import DEFAULT_SAMPLE_RATE, NUM_FORMANTS
from .approx import exp_approx, tan_approx_parts

__all__ = ["DEFAULT_SAMPLE_RATE", "NUM_FORMANTS", "exp_approx",
           "tan_approx_parts"]
