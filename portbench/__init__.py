"""The benchmark of ganreverser_tpu_torch on one NVIDIA H100 (README.md)."""
