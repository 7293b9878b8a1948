"""Roofline inputs for the port: the H100's data-sheet rates
(:mod:`.hw`) and the analytic model flops of a step (:mod:`.model_flops`).
The counterpart of ``src/repro/roofline``'s two modules that need no HLO
parser."""
from . import hw
from .model_flops import model_flops

__all__ = ["hw", "model_flops"]
