from repro_torch.configs.base import (  # noqa: F401
    GLOBAL_ATTN,
    ModelConfig,
    get_config,
    list_configs,
    register,
)
