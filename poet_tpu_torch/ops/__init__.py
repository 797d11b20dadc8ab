from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch  # noqa: F401
from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn  # noqa: F401
from poet_tpu_torch.ops.embeddings import (  # noqa: F401
    bbox_embedding_sine,
    position_embedding_sine,
)
