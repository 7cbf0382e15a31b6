"""surikatoko-tpu: a SLAM/SfM engine in JAX, run on NVIDIA GPUs.

A from-scratch re-design of the capabilities of the reference C++ codebase
whigg/surikatoko (Davison MonoSlam EKF + Kanatani bundle adjustment + incremental
multi-view factorization) for accelerators: fixed-shape pytree state, masked
dynamic landmark sets, batched/autodiff Jacobians, whole loops compiled as one
XLA program, and `shard_map` collectives for the multi-device distribution
layer the reference never had.

Layer map (mirrors SURVEY.md section 1):
  geom/      math core        (reference: suriko-engine obs-geom/quat/lin-alg)
  vision/    vision primitives (reference: templ-match, image-proc)
  world/     synthetic worlds  (reference: virt-world/scene-generator)
  models/    engines: monoslam EKF, ba (Kanatani LM+Schur), mvf (incremental SfM)
  ops/       batched primitives for the hot paths (NCC search)
  parallel/  mesh + sharded EKF/Schur (new: the reference is single-process)
  io/        config, serialization, stats logging, checkpointing
  utils/     rand/stat/approx helpers
"""

from surikatoko_tpu import config as config

__version__ = "0.1.0"
