from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    get_config,
    registry,
)
