"""The analysis pipelines of apply_r.lua; the names of
ganreverser_tpu/analysis/__init__.py that the port has, with the top-k
selections (``select_topk``, and ops/tiled_topk.py's two-pass
``tiled_topk`` and ``pixel_cosine_topk_tiled``).

The names are imported on first use (PEP 562), so that importing one
submodule (``analysis.graphs``, which the serving loader needs) does not
import the others and, through them, the models."""
import importlib

# module, relative to this package -> its names
_NAMES = {
    ".batched": ("forward_batched",),
    ".similarity": ("SimilarityIndex", "cosine_scores", "cosine_topk",
                    "normalize_rows", "pixel_cosine_topk", "select_topk",
                    "topk_recall"),
    ".kmeans": ("assign_euclidean", "assign_min_cosine", "cluster_members",
                "kmeans"),
    ".pipeline": ("anomaly_scores", "anomaly_threshold", "detect_anomalies",
                  "fix_images", "generate_and_invert", "variation_sweep"),
    ".e2e": ("chunked_topk_search", "make_distributed_e2e_program",
             "make_e2e_program", "make_serial_programs", "topk_all"),
    ".distributed": ("distributed_cosine_topk",
                     "distributed_generate_and_invert"),
    ".refine": ("make_refiner",),
    "..ops.tiled_topk": ("pixel_cosine_topk_tiled", "tiled_topk"),
}
_WHERE = {name: mod for mod, names in _NAMES.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_WHERE[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
