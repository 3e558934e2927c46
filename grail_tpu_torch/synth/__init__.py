from .elem import SynthesisElem

__all__ = ["SynthesisElem"]
