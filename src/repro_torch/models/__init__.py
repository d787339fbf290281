from repro_torch.models.lm import LM, ModelConfig  # noqa: F401
from repro_torch.models.registry import (  # noqa: F401
    ModelApi,
    get_config,
    get_model,
    list_archs,
)
