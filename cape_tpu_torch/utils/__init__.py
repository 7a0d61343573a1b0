"""Host utilities of the port (copies of `cape_tpu.utils`): metric
logging, the DEBUG_* toggles and the sequence helpers. Checkpoints wait
for their own slice."""

from .logging import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue"]
