"""The analysis pipelines of apply_r.lua; the names of
ganreverser_tpu/analysis/__init__.py that the port has."""
from .batched import forward_batched
from .similarity import (SimilarityIndex, cosine_scores, cosine_topk,
                         normalize_rows, pixel_cosine_topk, topk_recall)
from .kmeans import (assign_euclidean, assign_min_cosine, cluster_members,
                     kmeans)
from .pipeline import (anomaly_scores, anomaly_threshold, detect_anomalies,
                       fix_images, generate_and_invert, variation_sweep)
from .e2e import (chunked_topk_search, make_e2e_program,
                  make_serial_programs, topk_all)
from .refine import make_refiner
