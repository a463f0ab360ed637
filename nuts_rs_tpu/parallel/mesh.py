"""Mesh construction and chain/dim-axis sharding helpers.

Chains are the embarrassingly-parallel axis (the reference's rayon threads,
``src/sampler.rs:1286-1326``); here they shard over a ``Mesh`` axis named
``"chains"`` with ``shard_map``, so each device runs a vmapped block of
chains and adaptation pooling (see ``collectives.py``) runs as collectives.

The second distribution axis is the parameter dimension: a 2-D mesh
``("chains", "dim")`` additionally shards every parameter-indexed state array
(positions, gradients, momenta, checkpoint stacks, mass matrix) over
``"dim"``, with the kernels' contractions completed by ``psum`` (see
``parallel/axis.py``).  This is the huge-d scaling axis (BASELINE.json
config 5; SURVEY.md §5 "long-context analog").
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .axis import DIM_AXIS

CHAIN_AXIS = "chains"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the chains axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def make_mesh_2d(n_chain_devices: int, n_dim_devices: int) -> Mesh:
    """2-D mesh: chains x parameter-dimension.

    ``n_chain_devices * n_dim_devices`` devices are taken in order, with
    the ``dim`` axis innermost (fastest-varying).
    """
    n = n_chain_devices * n_dim_devices
    devices = np.asarray(jax.devices()[:n]).reshape(
        n_chain_devices, n_dim_devices)
    return Mesh(devices, (CHAIN_AXIS, DIM_AXIS))


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def chain_specs(tree: Any, dim: Optional[int] = None) -> Any:
    """PartitionSpecs for a chain-state pytree.

    Per-chain leaves shard their leading axis over ``chains``; when ``dim``
    is given (2-D mesh), floating leaves whose LAST axis has length ``dim``
    additionally shard that axis over ``dim`` (positions/gradients/momenta
    ``[C, d]``, mass-matrix diagonals ``[C, d]``, low-rank row blocks
    ``[C, d, r]`` are excluded by the last-axis rule and low-rank is not
    dim-shardable anyway).  Scalars are replicated.
    """

    def spec(x):
        nd = jnp.ndim(x)
        if nd == 0:
            return P()
        if (dim is not None and nd >= 2 and x.shape[-1] == dim
                and jnp.issubdtype(x.dtype, jnp.inexact)):
            return P(CHAIN_AXIS, *(None,) * (nd - 2), DIM_AXIS)
        return P(CHAIN_AXIS)

    return jax.tree.map(spec, tree)


def stats_specs(shape_tree: Any, dim: Optional[int]) -> Any:
    """PartitionSpecs for a per-chunk stats pytree shaped ``[k, C, ...]``.

    The chains axis is axis 1; parameter-indexed stats (``[k, C, d]``) shard
    their trailing axis over ``dim`` on a 2-D mesh.  Works on a tree of
    ``ShapeDtypeStruct`` (from ``jax.eval_shape``) or of arrays.
    """

    def spec(x):
        nd = len(x.shape)
        if nd == 0:
            return P()
        if nd == 1:
            return P(None)
        if (dim is not None and nd >= 3 and x.shape[-1] == dim
                and jnp.issubdtype(x.dtype, jnp.inexact)):
            return P(None, CHAIN_AXIS, *(None,) * (nd - 3), DIM_AXIS)
        return P(None, CHAIN_AXIS)

    return jax.tree.map(spec, shape_tree)


def shard_chain_state(state: Any, mesh: Mesh, dim: Optional[int] = None) -> Any:
    """Place a chain-state pytree on the mesh (chains axis sharded; with
    ``dim`` on a 2-D mesh, parameter axes sharded too)."""

    def put(x, s):
        return jax.device_put(x, NamedSharding(mesh, s))

    return jax.tree.map(put, state, chain_specs(state, dim))


def replicated_specs(tree: Any) -> Any:
    return jax.tree.map(lambda _: P(), tree)
