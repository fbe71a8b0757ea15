"""The port's device rule and its random-number streams.

Device: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the CPU tests do).  There is no fallback: asking for the
card where none is present raises, so a run that was meant for the GPU can
never quietly measure the CPU.

Random numbers: the reference keys its streams with ``jax.random.fold_in``
on a ``PRNGKey`` (``engine/round.py``: ``fold_in(key, r*131 + c*17 + s)``
per sweep, then ``fold_in(·, chunk)`` per sorted chunk).  The port keys a
stream by a tuple of integers instead: (seed, purpose, round, client,
sweep, chunk), and :func:`generator` turns that tuple into a seeded
``torch.Generator`` on the target device through numpy's ``SeedSequence``
(a hash of the whole tuple, so distinct tuples give unrelated streams and
nothing collides as the round index grows).  Torch's generators give other
numbers than JAX's from the same seed; parity tests therefore inject the
reference's uniforms instead of comparing streams.
"""

from __future__ import annotations

import numpy as np
import torch

Key = tuple[int, ...]

# Purposes of the streams a run draws (second element of every key): AUX
# keys the per-round auxiliary step (HDP's table counts and θ0); SERVE
# keys a served request's chain, (request seed, SERVE) at its root; FILTER
# keys a client's communication filter, (seed, FILTER, round, client);
# MODEL keys an LM's initial weights, (seed, MODEL).
INIT, SWEEP, EVAL, AUX, SERVE, FILTER, MODEL = 0, 1, 2, 3, 4, 5, 6


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for.  Raises if the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fold_in(key: Key, *ids: int) -> Key:
    """Extend a stream key, the counterpart of ``jax.random.fold_in``."""
    return key + tuple(int(i) for i in ids)


def generator(key: Key, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the whole key."""
    seed = np.random.SeedSequence([int(k) & 0xFFFFFFFF for k in key]
                                  ).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(seed[0]) << 31) ^ int(seed[1]))
    return gen
