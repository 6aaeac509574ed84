from repro_torch.configs.base import (  # noqa: F401
    GLOBAL_ATTN,
    ModelConfig,
    RunConfig,
    check_trainable,
    get_config,
    get_run_config,
    list_configs,
    register,
    register_run,
)
