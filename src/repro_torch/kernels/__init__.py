# The device-kernel substrate: one KernelSpec per distance (registry.py:
# wavefront dtw/erp/dfd/lev + elementwise euclidean/hamming), packed
# ragged-bucket dispatch (dispatch.py), the hand-written CUDA kernels with
# their plain torch versions (wavefront.py + csrc/wavefront.cu,
# pairwise_l2.py + csrc/pairwise_l2.cu), their public entry points
# (ops.py) and oracles (ref.py), and the nvcc build + ctypes loader
# (build.py).
