"""Host C++ image ops (imageops.cc) behind ctypes, with numpy paths
where no compiler is found: the counterpart of ganreverser_tpu/native."""
from .imageops import (assemble_grid, available, normalize_pm1_inplace,
                       resize_bilinear_batch, rgb2y_native, rgb2yuv_native,
                       yuv2rgb_native)
