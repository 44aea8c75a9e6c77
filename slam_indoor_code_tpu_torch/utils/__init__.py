from .timer import ChronoTimer
from .padding import round_up_to_multiple, pad_to, cdiv

__all__ = ["ChronoTimer", "round_up_to_multiple", "pad_to", "cdiv"]
