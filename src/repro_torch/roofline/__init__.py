"""Roofline inputs for the port: the H100's data-sheet rates
(:mod:`.hw`), the analytic model flops of a step (:mod:`.model_flops`),
per-device counts of a torch program and their roofline terms
(:mod:`.analyze`), and the dry-run's tables (:mod:`.report`).  The
counterpart of ``src/repro/roofline``."""
from . import hw
from .model_flops import model_flops

__all__ = ["hw", "model_flops"]
