from .timer import Timer, TimingResult, timings_to_string
from .rng import set_seed, host_rng, new_generator

__all__ = ["Timer", "TimingResult", "timings_to_string", "set_seed", "host_rng", "new_generator"]
