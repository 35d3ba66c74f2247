"""repro_torch.dist — the static-partitioning half of the GLB thesis. The
counterpart of ``repro.dist``, over ``torch.distributed``.

The lifeline work-stealer (``repro_torch.core``) balances *dynamic*
workloads at run time; this package is its static counterpart: how model,
optimizer, cache and activation tensors are laid out over a mesh, and the
collectives both use.

  collectives : the seven ``shard_map`` collectives of the JAX package
                (all_gather, tiled all_to_all, ppermute, psum / pmax /
                pmin, pmean) over one mesh dimension's process group;
                the one place where gloo's host staging happens.
  sharding    : logical-axis rule engine — params, inputs, caches and
                activations name *logical* axes and the engine resolves
                them to mesh specs and DTensor placements.
  compress    : int8 error-feedback compressed mean all-reduce for the
                data-parallel gradient sync.
  pipeline    : microbatched GPipe-style pipeline parallelism over a
                ``stage`` mesh dimension.
"""
from .compress import compressed_psum_mean, init_error, quantize_roundtrip
from .pipeline import pipeline_forward, split_layers_into_stages
from .sharding import (
    batch_axes,
    cache_axes,
    opt_axes,
    param_axes,
    shard_act,
    spec_for,
    tree_shardings,
    tree_specs,
)

__all__ = [
    "batch_axes", "cache_axes", "opt_axes", "param_axes", "shard_act",
    "spec_for", "tree_shardings", "tree_specs",
    "compressed_psum_mean", "init_error", "quantize_roundtrip",
    "pipeline_forward", "split_layers_into_stages",
]
