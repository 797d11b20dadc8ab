from poet_tpu_torch.data.structures import Targets, pad_targets  # noqa: F401
