from transformer_transducer_tpu_torch.parallel import mesh  # noqa: F401
from transformer_transducer_tpu_torch.parallel import sharding  # noqa: F401
