"""Launch-side layers of the port: the elastic sharded fleet
(``elastic.py``) and the continuous-batching serve CLI (``serve.py``)."""
