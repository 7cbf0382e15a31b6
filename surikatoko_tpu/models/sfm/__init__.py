"""Multi-view geometry front-end: the capabilities of the reference's Python
prototype (py_proto/suriko/mvg.py, SURVEY §2.4) re-built as batched JAX.

homography DLT + decomposition, fundamental 8/7-point, essential-matrix
estimation + pose extraction with cheirality, Sampson correction, and a
batched vmapped RANSAC engine (hypotheses evaluated in parallel instead of
the prototype's sequential loop).
"""

from surikatoko_tpu.models.sfm import mvg as mvg
from surikatoko_tpu.models.sfm import ransac as ransac
from surikatoko_tpu.models.sfm import autocalib as autocalib
from surikatoko_tpu.models.sfm import five_point as five_point
