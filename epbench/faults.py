"""Faults planted under the timed path, for the checks' own tests: each
breaks the port (or the harness's use of it) in one way that a sound
``correct`` must catch.  ``plant(name)`` returns a function that takes
the fault out again.

* ``token_altered``: a served token changed where it is produced (the
  decode step's logits shifted toward another token).
* ``exchange_skipped``: the EP exchange between ranks left out (every
  all-to-all returns its send buffers).
* ``state_unchanged``: a step that returns its state unchanged (decode:
  the K/V rows never written; training: AdamW a no-op).
* ``half_batch``: half of each batch left out: training takes the mean
  loss over the first half; a decode step serves the second half's
  sequences no logits (all zero).
"""
from __future__ import annotations

import functools

import torch

FAULTS = ("token_altered", "exchange_skipped", "state_unchanged",
          "half_batch")


def _swap(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def plant(name: str):
    from repro_torch.core import ep
    from repro_torch.models import blocks, model_zoo as Z
    from repro_torch.optim import adamw

    if name == "token_altered":
        def shifted(fn):
            @functools.wraps(fn)
            def run(*a, **k):
                logits, cache, aux = fn(*a, **k)
                bump = torch.zeros_like(logits)
                bump[..., 7] = 1e4          # token 7 wins every argmax
                return logits + bump, cache, aux
            return run
        return _swap(Z, "decode_step", shifted(Z.decode_step))
    if name == "exchange_skipped":
        return _swap(ep, "_all_to_all", lambda spec, t, axis: t)
    if name == "state_unchanged":
        undo = []
        real = blocks.block_decode

        def no_write(cfg, dist, p, x, cache, pos, **k):
            scratch = {n: t.clone() for n, t in cache.items()}
            x, _, aux = real(cfg, dist, p, x, scratch, pos, **k)
            return x, cache, aux
        undo.append(_swap(blocks, "block_decode", no_write))
        undo.append(_swap(adamw, "apply_updates",
                          lambda params, grads, state, **k: (
                              params, state, {"grad_norm": torch.zeros(())})))
        return lambda: [u() for u in reversed(undo)]
    if name == "half_batch":
        undo = []
        real_loss = Z.loss_fn

        def half(cfg, params, tokens, labels, *a, **k):
            h = tokens.shape[0] // 2
            return real_loss(cfg, params, tokens[:h], labels[:h], *a, **k)

        def half_step(fn):
            @functools.wraps(fn)
            def run(*a, **k):
                logits, cache, aux = fn(*a, **k)
                keep = torch.ones_like(logits)
                keep[logits.shape[0] // 2:] = 0
                return logits * keep, cache, aux
            return run
        undo.append(_swap(Z, "loss_fn", half))
        undo.append(_swap(Z, "decode_step", half_step(Z.decode_step)))
        return lambda: [u() for u in reversed(undo)]
    raise KeyError(f"unknown fault {name!r}; known: {FAULTS}")
