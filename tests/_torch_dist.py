"""Rank functions of the port's multi-rank CPU tests
(``tests/test_torch_distributed.py``).  A spawned rank imports its function
by module path, so they live here, in a module that imports no JAX."""

import numpy as np
import torch


def topk_rank(rank, world, dev, sq, ids, k):
    """Rank ``rank`` of a 2 x 2 gloo mesh: its (Q, K) window of ``sq`` /
    ``ids`` (indexed (a, b) by its mesh coordinate) through
    ``hierarchical_topk`` over ("b", "a"); with the shape of
    ``make_host_mesh(2, 2)`` and the error it raises for a (4, 2) shape the
    group cannot hold."""
    from repro_torch.distributed.collectives import hierarchical_topk
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    mesh = make_mesh((2, 2), ("a", "b"), "cpu")
    a, b = mesh.get_coordinate()
    out_sq, out_ids = hierarchical_topk(torch.as_tensor(sq[a, b]), torch.as_tensor(ids[a, b]),
                                        mesh, ("b", "a"), k)
    host = make_host_mesh(2, 2)
    try:
        make_host_mesh(4, 2)
        too_big = ""
    except ValueError as e:
        too_big = str(e)
    return out_sq.numpy(), out_ids.numpy(), (tuple(host.shape), host.mesh_dim_names), too_big


def flat_rank(rank, world, dev, svc, rows, codes, bscales, queries, eps, scale, eps_lo,
              shards):
    """Rank ``rank`` of an R-rank flat mesh step over its ``rows`` share;
    with the step's input specs over the mesh (shape, dtype, placement)."""
    from repro_torch.launch.annservice import build_search_step, search_input_specs
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("rank",), "cpu")
    n_local = rows.shape[0] // world
    part = slice(rank * n_local, (rank + 1) * n_local)
    step = build_search_step(svc, with_stats=True, shards=shards, mesh=mesh)
    t = torch.as_tensor
    d, i, scan = step(t(rows[part]), t(codes[part]), t(bscales), t(queries), t(eps),
                      t(scale), t(eps_lo))
    specs = [(tuple(x.shape), str(x.dtype),
              f"Shard({x.placements[0].dim})" if x.placements[0].is_shard() else "Replicate")
             for x in search_input_specs(svc, mesh, quant="int8", fused=True)]
    return d.numpy(), i.numpy(), np.asarray(scan), specs
