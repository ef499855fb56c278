from .checkpoint import (CheckpointManager, load_checkpoint,  # noqa: F401
                         save_checkpoint)
from .monitor import (HeartbeatMonitor, RestartPolicy,        # noqa: F401
                      StragglerReport)
