"""Host utilities of the port (copies of `cape_tpu.utils`): metric
logging, the DEBUG_* toggles, the sequence helpers and checkpoints (in
torch's own format)."""

from .checkpoint import CheckpointManager
from .logging import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue", "CheckpointManager"]
