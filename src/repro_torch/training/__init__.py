from .optimizer import (OptimizerConfig, adamw_init, adamw_update,  # noqa
                        make_optimizer, sgd_init, sgd_update)
from .grad_compress import (CompressorState, compress_decompress,   # noqa
                            log_compress_gradients, make_compressor)
from .train_loop import TrainConfig, TrainState, make_train_step, train  # noqa
