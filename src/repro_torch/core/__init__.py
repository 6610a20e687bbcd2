# The paper's system on the host: frontier plans and the batch engine
# (batch_engine.py), the reference net (refnet.py), the paper's comparison
# indexes (covertree.py, refindex.py), the 5-step matcher (matching.py,
# segmentation.py), and the counted evaluation substrate that sends every
# exact distance to the device kernels (counter.py).
