"""A gloo process group of W CPU processes for the port's op-level tests
(ring attention, the pipeline schedule, expert-parallel layers): each
process joins the group, runs ``fn(rank, world, *args)`` and sends its
result back.  No JAX is imported here or in the processes."""

import multiprocessing as mp
import traceback


def _child(fn, rank, world, port, args, queue):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}")
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def run_gloo(fn, world: int, *args, timeout: float = 120.0) -> list:
    """``[fn(r, world, *args) for r in range(world)]``, each in a process
    of its own joined into one gloo group; a rank's exception raises here
    with its traceback."""
    from ray_lightning_tpu_torch.cluster.protocol import find_free_port
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = find_free_port()
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return [out[r] for r in range(world)]
