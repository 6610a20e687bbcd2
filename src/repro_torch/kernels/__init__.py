# The device-kernel substrate: one KernelSpec per distance (registry.py:
# wavefront dtw/erp/dfd/lev + elementwise euclidean/hamming), packed
# ragged-bucket dispatch (dispatch.py), the hand-written CUDA wavefront
# kernel with its plain torch version (wavefront.py, csrc/wavefront.cu),
# and the nvcc build + ctypes loader (build.py).
