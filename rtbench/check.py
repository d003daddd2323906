"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of what the window served is run through the plain
float32 reference (``reference/models.py``) on the same weights and the
same payloads:

- prompt frames: the served next token (the argmax the engine returned)
  against the reference's logits at the prompt's last position;
- decode streams: at every step of the stream, the argmax of the served
  logits of the stream's own arena row against the reference's logits at
  that position, the reference's state worked out again from the tokens
  the row consumed (in the order its steps consumed them).

The number compared for each kind is the widest gap by which a served
token's reference logit lies below the reference's best at that
position (0 where the served token is the reference's argmax). The
sample holds the longest prompts and the stream with the most steps.
With ``control=True`` the same positions are read again with the
reference's weights rounded through float8 (the control): its gap is
that of the token the lower precision puts first.
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from rtbench.reference import models

BLOCK_ROWS = 8  # sequences a reference forward takes at once


def _sample(items: List, n: int, key, rng: random.Random) -> List:
    """``n`` items: the largest by ``key``, then a draw from the rest."""
    if len(items) <= n:
        return list(items)
    ordered = sorted(items, key=key, reverse=True)
    rest = ordered[1:]
    return [ordered[0]] + rng.sample(rest, n - 1)


def _gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref: (N, V) reference logits; served: (N,) token ids."""
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, served[:, None].long())[:, 0]


def _spread(g: torch.Tensor) -> Dict[str, float]:
    """The widest gap (the number compared), with its count and the
    median and 99th percentile beside it."""
    q = torch.quantile(g.float().cpu(), torch.tensor([0.5, 0.99])).tolist()
    return {"value": float(g.max()), "n": int(g.numel()), "p50": q[0], "p99": q[1]}


def prefill_frames(jobs, streams) -> List[Tuple[int, torch.Tensor, int, bool, int]]:
    """(rid, prompt tokens as the job ran them, served next token, whether
    its job ran shrunk, the job's batch bucket) of every served prompt frame. A job the adaptation
    module shrank runs each prompt's first ``job.length`` tokens; the frame
    log counts such a frame failed, and the reference answers the prompt
    the job ran."""
    out = []
    for job in jobs:
        if job.kind != "prefill":
            continue
        ids = job.served_host
        for j, (rid, idx) in enumerate(job.frames):
            toks = streams[rid].source.payload(idx).astype("int64")[: job.length]
            out.append((rid, torch.from_numpy(toks), int(ids[j]), job.shrunk, job.bucket))
    return out


def decode_steps(jobs) -> Dict[int, List[Tuple[int, int]]]:
    """rid -> [(consumed token, served token)] in step order."""
    steps: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for job in jobs:
        if job.kind != "decode":
            continue
        served = job.served_host
        for rid, row, tok in job.decode_rows:
            steps[rid].append((tok, int(served[row])))
    return steps


def run_check(family, tree, dims: Dict, jobs, streams: Dict, check_spec: Dict,
              seed: int, device, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each ``{"value", "n"}`` (and ``"control"``
    when asked): ``prefill_gap`` over the sampled prompt frames,
    ``decode_gap`` over every step of the sampled decode streams."""
    rng = random.Random(f"rtbench-check-{int(seed)}")
    fp32 = models.convert_for("float32")
    low = models.convert_for("fp8")
    out: Dict[str, Dict[str, float]] = {}

    frames = prefill_frames(jobs, streams)
    if frames:
        picked = _sample(frames, int(check_spec["prefill_frames"]), lambda f: len(f[1]), rng)
        by_len = defaultdict(list)
        for f in picked:
            by_len[len(f[1])].append(f)
        gaps, ctl = [], []
        for length, group in sorted(by_len.items()):
            for i in range(0, len(group), BLOCK_ROWS):
                block = group[i:i + BLOCK_ROWS]
                toks = torch.stack([f[1] for f in block]).to(device)
                served = torch.tensor([f[2] for f in block], device=device)
                ref = models.logits(tree, models.hidden(family, tree, toks, dims, fp32)[:, -1], fp32)
                gaps.append(_gaps(ref, served))
                if control:
                    h = models.hidden(family, tree, toks, dims, low)[:, -1]
                    ctl.append(_gaps(ref, models.logits(tree, h, low).argmax(-1)))
        g = torch.cat(gaps)
        order = [f for _, group in sorted(by_len.items()) for f in group]
        out["prefill_gap"] = dict(_spread(g), shrunk=sum(f[3] for f in picked), frames=[
            (len(f[1]), f[4], int(f[3]), round(float(x), 5)) for f, x in zip(order, g.tolist())])
        if control:
            out["prefill_gap"]["control"] = float(torch.cat(ctl).max())

    steps = decode_steps(jobs)
    if steps:
        rids = _sample(sorted(steps), int(check_spec["decode_streams"]),
                       lambda r: len(steps[r]), rng)
        gaps, ctl = [], []
        for i in range(0, len(rids), BLOCK_ROWS):
            block = rids[i:i + BLOCK_ROWS]
            longest = max(len(steps[r]) for r in block)
            toks = torch.zeros((len(block), longest), dtype=torch.long)
            for j, r in enumerate(block):
                toks[j, :len(steps[r])] = torch.tensor([t for t, _ in steps[r]])
            toks = toks.to(device)
            h = models.hidden(family, tree, toks, dims, fp32)
            hl = models.hidden(family, tree, toks, dims, low) if control else None
            for j, r in enumerate(block):
                n = len(steps[r])
                served = torch.tensor([s for _, s in steps[r]], device=device)
                for a in range(0, n, 256):
                    b = min(a + 256, n)
                    ref = models.logits(tree, h[j, a:b], fp32)
                    gaps.append(_gaps(ref, served[a:b]))
                    if control:
                        lg = models.logits(tree, hl[j, a:b], low)
                        ctl.append(_gaps(ref, lg.argmax(-1)))
            del h, hl
        g = torch.cat(gaps)
        out["decode_gap"] = _spread(g)
        if control:
            out["decode_gap"]["control"] = float(torch.cat(ctl).max())
    return out


def verdict(numbers: Dict[str, Dict[str, float]], limits: Dict[str, Optional[float]]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and at least one number compared."""
    rows = [(k, v["value"], limits.get(k)) for k, v in sorted(numbers.items())]
    ok = bool(rows) and all(lim is not None and val <= lim for _, val, lim in rows)
    return ok, rows
