from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch  # noqa: F401
from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn  # noqa: F401
from poet_tpu_torch.ops.embeddings import (  # noqa: F401
    bbox_embedding_sine,
    position_embedding_sine,
)
# the custom operators (`torch.ops.poet_tpu_torch.*`) a traced program calls:
# importing the package registers them all
from poet_tpu_torch.ops.conv_stem_cuda import conv_stem  # noqa: F401,E402
from poet_tpu_torch.ops.darknet_epilogue_cuda import darknet_epilogue  # noqa: F401,E402
from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense  # noqa: F401,E402
from poet_tpu_torch.ops.roi_align_cuda import multiscale_roi_align  # noqa: F401,E402
