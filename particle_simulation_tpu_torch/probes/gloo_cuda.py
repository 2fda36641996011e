"""Which collectives of the sharded step gloo runs on CUDA tensors.

    python -m particle_simulation_tpu_torch.probes.gloo_cuda

Two ranks share the card over gloo (``launch.run(..., backend="gloo")``);
each collective that ``parallel.sharded.Mesh`` runs is tried on CUDA
tensors in two ranks of its own and its result checked.  A collective
that gloo refuses raises, or aborts its ranks, and is reported as refused:
``sharded.GLOO_CUDA_REFUSED`` lists those, which ranks that share a card
run on host copies.  Prints one JSON object: the torch version and each
collective's verdict.
"""

from __future__ import annotations

import json

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _all_reduce(dev, r, d, group):
    ok = True
    for op, want in (("SUM", sum(range(1, d + 1))), ("MIN", 1), ("MAX", d)):
        t = torch.full((4,), r + 1, dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=group)
        ok &= bool((t == want).all())
    return ok


def _reduce_scatter(dev, r, d, group):
    from ..parallel.sharded import _single

    t = torch.arange(2 * d, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    _single("reduce_scatter_single", "reduce_scatter_tensor")(
        out, t, group=group)
    return out.tolist() == [d * (2 * r), d * (2 * r + 1)]


def _all_gather(dev, r, d, group):
    from ..parallel.sharded import _single

    t = torch.full((3,), float(r), device=dev)
    out = torch.empty(3 * d, device=dev)
    _single("all_gather_single", "all_gather_into_tensor")(
        out, t, group=group)
    return out.tolist() == [float(i) for i in range(d) for _ in range(3)]


def _halo(dev, r, d, group):
    send = torch.full((4,), r, dtype=torch.int32, device=dev)
    recv = torch.empty(4, dtype=torch.int32, device=dev)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (r + 1) % d, group),
        dist.P2POp(dist.irecv, recv, (r - 1) % d, group)])
    for q in reqs:
        q.wait()
    return bool((recv == (r - 1) % d).all())


COLLECTIVES = {"all_reduce": _all_reduce, "reduce_scatter": _reduce_scatter,
               "all_gather": _all_gather, "halo": _halo}


def probe_rank(mesh, name: str) -> str:
    """Rank function: the collective ``name`` on CUDA tensors over the
    mesh's gloo group, with its result checked."""
    try:
        ok = COLLECTIVES[name](mesh.device, mesh.rank, mesh.size, mesh.group)
    except (RuntimeError, ValueError) as e:  # the probe's answer
        return "refused: " + str(e).splitlines()[0][:160]
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return "accepted" if ok else "wrong result"


def probe() -> dict:
    """Each collective in two ranks of its own (a refusal may abort the
    process): name -> verdict of rank 0, or how the ranks ended."""
    from ..parallel import launch

    verdicts = {}
    for name in COLLECTIVES:
        try:
            res = launch.run(probe_rank, 2, args=(name,), device="cuda",
                             backend="gloo", timeout_s=120)
            verdicts[name] = (res[0] if res[0] == res[1]
                              else f"ranks differ: {res}")
        except mp.ProcessExitedException as e:  # the probe's answer
            verdicts[name] = f"refused: a rank ended ({e})"
    return verdicts


def main() -> int:
    print(json.dumps({"torch": torch.__version__, "gloo_on_cuda": probe()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
