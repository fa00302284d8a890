"""ganreverser_tpu_torch — the PyTorch + CUDA port of ganreverser_tpu.

The port runs on one NVIDIA Hopper card (sm_90a). Plain tensor code is
PyTorch; every Pallas kernel that the JAX package runs on the ported path is
a kernel written by hand in CUDA C++ (``csrc/``), built with nvcc at first
use and bound with ctypes (``ops/cuda_lib.py``).

Module paths mirror the JAX package, so each counterpart is found by name:

* ``core``     — configs (``config``), noise (``prng``)
* ``io``       — the checkpoint directory format (``checkpoint``), serving
                 artifacts (``serving``)
* ``models``   — eval-mode ``nn.Module``s (``modules``, ``zoo``), the weight
                 bridge to the JAX variable trees (``bridge``) and the fast
                 forwards through the kernels (``fastpath``)
* ``ops``      — the kernels' wrappers, their plain versions and their
                 ``torch.library`` operators (``library``)
* ``analysis`` — batched forwards, cosine top-k, generate + invert
* ``cli``      — ``apply_r`` (generate + invert + similarity search)

Layout is the JAX package's: NHWC activations, HWIO conv weights, (in, out)
dense weights and the (H, W, C) flatten order at every public function.
This package imports neither jax nor ganreverser_tpu.
"""

__version__ = "0.1.0"
