from .whisper_torch import (  # noqa: F401
    TINY_TEST_DIMS,
    KVCache,
    WhisperDims,
    WhisperTorch,
    cast_params,
    count_parameters,
    decode_full,
    decode_step,
    encode,
    init_cache,
    init_params,
    sinusoids,
)
from .load import (  # noqa: F401
    WhisperModel,
    available_models,
    dims_from_hf_config,
    from_hf_state_dict,
    from_openai_state_dict,
    load_model,
    params_from_jax_tree,
)
from .alignment_heads import ALIGNMENT_HEADS, get_alignment_heads  # noqa: F401
