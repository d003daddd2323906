"""Training launcher: end-to-end sharded training with checkpointing and a
crash drill (the twin of ``repro.launch.train``).

It trains on the host mesh (``launch/mesh.make_host_mesh``) as the
reference's launcher does: the activation resolver is installed, the
state is laid out as DTensors by ``shardings_for_state``, and the
resolver is cleared in ``finally``. One process drives one device, so on
its own this is a (1, 1) mesh over ``--device`` (the card by default, on
NCCL; ``--device cpu`` is a gloo mesh of one rank on the CPU); started as
N ranks of a ``torch.distributed`` group, it spans them. Checkpoints are
written from full tensors and a restore is laid out on the mesh again.
The port's counterpart of ``examples/train_small.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --tiny --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Fault tolerance drill: --fail-at N simulates a crash after step N; rerun
the same command and training resumes from the latest checkpoint with
the same data order (the pipeline is seekable by step). The last line,
``final state digest``, is a SHA-256 over every leaf of the final state,
so a straight run and a crashed-and-resumed one can be compared bit for
bit.
"""
from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
from repro_torch.configs.registry import get_config, tiny
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_for
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from repro_torch.training.data import DataConfig, SyntheticTokens


def state_digest(state) -> str:
    """SHA-256 over every leaf's name, dtype and bytes, in checkpoint order."""
    h = hashlib.sha256()
    for name, leaf in leaf_paths(state):
        t = leaf.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device and torch.cuda.is_available() is "
                         "False; pass --device cpu to train on the CPU")
    cfg = tiny(args.arch) if args.tiny else get_config(args.arch)
    model = model_for(cfg)
    tcfg = train_loop.TrainConfig(
        adamw=opt.AdamWConfig(peak_lr=args.lr, warmup_steps=5, total_steps=args.steps),
        grad_accum=args.grad_accum,
    )
    data = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))
    step_fn = train_loop.make_train_step(model, tcfg)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    mesh = make_host_mesh(device=args.device)
    shd.install_activation_resolver(mesh)
    try:
        state_sh = train_loop.shardings_for_state(model, mesh)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = train_loop.init_state(model, gen, device=device)
        if mgr is not None and mgr.latest_step() is not None:
            start_step = mgr.latest_step()
            print(f"resuming from checkpoint step {start_step}")
            state = mgr.restore(start_step, state, device=device)
            train_loop.trainable(state.params)
        state = train_loop.place_state(state, state_sh)
        losses = []
        for i in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
            batch = train_loop.place_batch(batch, mesh)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            if i % 10 == 0 or i == args.steps - 1:
                print(
                    f"step {i:4d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms"
                )
            if mgr is not None and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, train_loop.full_state(state))
            if args.fail_at is not None and i + 1 >= args.fail_at:
                if mgr is not None:
                    mgr.wait()
                raise SystemExit(f"simulated failure at step {i + 1} (rerun to resume)")
        final = train_loop.full_state(state)
        if mgr is not None:
            mgr.save(args.steps, final, blocking=True)
        if len(losses) >= 10:
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            print(f"loss {first:.4f} -> {last:.4f} "
                  f"({'improved' if last < first else 'NOT improved'})")
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on {mesh.device_type}")
        print(f"final state digest: {state_digest(final)}")
    finally:
        shd.clear_activation_resolver()


if __name__ == "__main__":
    main()
