"""Host preprocessing of raw ZTF object directories (NumPy and the
standard library; no pandas): the readers the raw-alert serving path
needs.

``Config`` and ``compute_feature_stats_safe`` are the reference's names of
``PreprocessConfig`` and ``compute_feature_stats``."""

from applecider_tpu_torch._lazy import lazy_names

# the JAX package's public names of this package, imported at first use
_NAMES = {
    "PreprocessConfig": ("applecider_tpu_torch.preprocessing.config", "PreprocessConfig"),
    "Config": ("applecider_tpu_torch.preprocessing.config", "PreprocessConfig"),
    "build_all_preprocessed": ("applecider_tpu_torch.preprocessing.builder", "build_all_preprocessed"),
    "build_multimodal_for_object": ("applecider_tpu_torch.preprocessing.builder", "build_multimodal_for_object"),
    "make_splits_from_manifest": ("applecider_tpu_torch.preprocessing.manifest", "make_splits_from_manifest"),
    "compute_feature_stats": ("applecider_tpu_torch.preprocessing.manifest", "compute_feature_stats"),
    "compute_feature_stats_safe": ("applecider_tpu_torch.preprocessing.manifest", "compute_feature_stats"),
    "find_available_ids": ("applecider_tpu_torch.preprocessing.manifest", "find_available_ids"),
    "write_manifest_csv": ("applecider_tpu_torch.preprocessing.manifest", "write_manifest_csv"),
}
__all__ = [*_NAMES]
__getattr__, __dir__ = lazy_names(__name__, _NAMES, globals())
