"""Math core: quaternions, SO(3)/SE(3), camera model, triangulation, ellipses.

Equivalent of the reference's obs-geom/quat/lin-alg layer
(suriko-engine/include/suriko/obs-geom.h, quat.h) — pure functions over JAX
arrays, Taylor-safe near singularities so everything is jit/grad-safe.
"""

from surikatoko_tpu.geom import quat as quat
from surikatoko_tpu.geom import so3 as so3
from surikatoko_tpu.geom import se3 as se3
from surikatoko_tpu.geom import camera as camera
from surikatoko_tpu.geom import rect as rect
from surikatoko_tpu.geom import triangulate as triangulate
from surikatoko_tpu.geom import ellipse as ellipse
from surikatoko_tpu.geom import align as align
