"""Op counts of the port's programs (``ops.py``, the counterpart of the
reference's ``repro/analysis/hlo.py``), which the dry-run
(``repro_torch.launch.dryrun``) reads."""
from .ops import COLLECTIVES, OpAnalysis, OpCounter, count_ops, storage_bytes

__all__ = ["COLLECTIVES", "OpAnalysis", "OpCounter", "count_ops",
           "storage_bytes"]
