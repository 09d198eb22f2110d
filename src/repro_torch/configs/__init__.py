from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    SHAPES,
    get_arch,
    input_specs,
    list_archs,
    reduced,
    shape_applicable,
)
