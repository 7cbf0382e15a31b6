"""Batched primitives for the engine's hot paths (SURVEY §3.4: the NCC
search)."""

from surikatoko_tpu.ops import ncc as ncc
