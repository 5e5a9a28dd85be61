"""Speculative decoding: layer-skip self-draft, exact greedy acceptance.

Counterpart of `tpu_dra.parallel.speculative`, on one device or on a
mesh of ranks.  A cheap
DRAFT (the model's own first ``draft_layers`` blocks, the final norm and
the tied logits head: no second set of weights) proposes ``draft_len``
tokens autoregressively; the full model scores all of them in ONE
verify pass of ``draft_len + 1`` positions (`decode.decode_forward`),
and the longest agreeing prefix commits.  Every round commits at least
one token, so the worst case is plain decode plus the draft.

- Greedy (``temperature == 0``): the output equals `make_generate`'s
  token for token for any draft; the draft only changes how many rounds
  it takes.
- Sampled: the stochastic correction (Leviathan et al.): draft token x
  is accepted with probability ``min(1, p(x) / q(x))``, a rejection
  resamples from ``normalize(max(0, p - q))``, and a full acceptance
  draws the bonus token from the target, so the output is distributed as
  target-only sampling.  The keys follow the reference's schedule
  (`prng`, JAX's Threefry bit for bit): ``split(key)`` for the first
  token, ``split(key, 5)`` a round and ``split(kd, draft_len + 1)`` for
  the draft, so the port draws the reference's tokens, not only their
  distribution.

Rejected-suffix cache entries are overwritten by the next round's
writes, never rolled back: attention masks by position and the frontier
moves only over committed tokens.  Batched rows commit at the batch
consensus (the least accepted prefix over the rows).  The reference's
``lax.while_loop`` is a host loop here: its condition, the frontier,
is read once a round, which makes ONE host sync a round.  The cache is
contiguous (`decode.init_cache`): no paged-attention kernel runs here.

On a mesh (``mesh=``) every rank runs the rounds on its shards, the
draft sharded as the target is (its leading layers): picks, draws and
the acceptance test run on the rows of the rank's fsdp group (`decode`'s
layout), each draw under one key taking its rows of the global
``(B, ...)`` draw; every pick is made global by one all-gather over
``data``, and the batch consensus is taken over the global rows, so
every rank commits alike and returns the global tokens.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_dra_torch.parallel import prng
from tpu_dra_torch.parallel.burnin import BurninConfig
from tpu_dra_torch.parallel.decode import (
    _build_prefill,
    _categorical,
    _check_window,
    _forward,
    _key_or_raise,
    _place,
    _rows,
    _to_global,
    _validate,
    decode_forward,
    init_cache,
)

__all__ = [
    "accept_or_resample",
    "acceptance_flags",
    "draft_params",
    "make_generate_speculative",
    "residual_sample",
]


def _probs(logits, temperature: float):
    return torch.softmax(logits / temperature, dim=-1)


def acceptance_flags(u, target_logits, draft_logits, draft_tok, temperature: float = 1.0):
    """The acceptance test, elementwise over any leading shape: accept
    draft token ``x`` iff ``u < p(x) / q(x)``, ``p``/``q`` the
    temperature-scaled target/draft softmaxes."""
    idx = draft_tok.long()[..., None]
    p_x = _probs(target_logits, temperature).gather(-1, idx)[..., 0]
    q_x = _probs(draft_logits, temperature).gather(-1, idx)[..., 0]
    return u < p_x / q_x.clamp(min=1e-20)


def residual_sample(key, target_logits, draft_logits, temperature: float = 1.0, rows=None):
    """The rejection branch: a draw from ``normalize(max(p - q, 0))``
    under ``key``; a residual of zero mass (``p == q``, where acceptance
    is certain) falls back to ``p``.  Logits (..., V) -> tokens (...,)
    int32.  ``rows``: the logits are a mesh rank's group's rows of the
    global batch (`decode._categorical`)."""
    p = _probs(target_logits, temperature)
    q = _probs(draft_logits, temperature)
    resid = (p - q).clamp(min=0.0)
    mass = resid.sum(-1, keepdim=True)
    resid = torch.where(mass > 0, resid / mass.clamp(min=1e-20), p)
    return _categorical(key, torch.log(resid + 1e-20), rows).to(torch.int32)


def accept_or_resample(key, target_logits, draft_logits, draft_tok, temperature: float = 1.0):
    """One position of stochastic speculative sampling, batched: returns
    ``(token, accepted)``, `acceptance_flags` under a fresh uniform and
    `residual_sample`, their keys ``split(key)``."""
    ku, kr = prng.split(key)
    u = prng.uniform(ku, draft_tok.shape)
    accepted = acceptance_flags(u, target_logits, draft_logits, draft_tok, temperature)
    resampled = residual_sample(kr, target_logits, draft_logits, temperature)
    return torch.where(accepted, draft_tok.to(torch.int32), resampled), accepted


def _leading(tree, n: int, copy: bool = False):
    """The first ``n`` entries of the leading (layer) axis of every
    tensor leaf of a nested dict: views, or copies with ``copy``."""
    if isinstance(tree, dict):
        return {k: _leading(v, n, copy) for k, v in tree.items()}
    return tree[:n].clone() if copy else tree[:n]


def draft_params(params: dict, draft_layers: int) -> dict:
    """The layer-skip draft's view of the serving params: the first
    ``draft_layers`` blocks (plain and int8 ``{"q","s"}`` leaves alike),
    the shared embedding, positions, final norm and logits head."""
    return {**params, "layers": _leading(params["layers"], draft_layers)}


def make_generate_speculative(config: BurninConfig, mesh=None, *, prompt_len: int,
                              steps: int, draft_layers: int, draft_len: int,
                              temperature: float = 0.0, with_stats: bool = False,
                              kv_int8: bool = False):
    """Build ``fn(params, prompt (B, prompt_len)[, key]) -> (B,
    prompt_len + steps)`` on one device, or on a ``mesh`` as
    `decode.make_generate` is (every rank its shards of ``params``, the
    global prompt in, the global tokens out; the reference's
    ``quantized`` names shardings the tree itself tells here).
    ``temperature == 0`` is greedy and equals `decode.make_generate`'s
    output (on a mesh, up to the sharded logits' near-ties); above 0 it samples
    under ``key`` (a ``(2,)`` `prng` key).  ``draft_layers``: the draft's
    depth (1..n_layers); ``draft_len``: tokens proposed a round (the
    context needs ``prompt_len + steps + draft_len`` slots: a last round
    may overshoot before truncation).  ``with_stats`` returns
    ``(tokens, rounds, healthy)``: full-model passes used (``steps /
    rounds`` tokens a pass) and the all-logits-finite flag (a device
    bool).  Dense configs only, as in the reference: a truncated layer
    stack would route the experts' capacity queues another way."""
    c = config
    _validate(c)
    if c.moe_experts > 0:
        raise ValueError(
            "speculative decoding supports dense configs only: a "
            "truncated layer stack re-routes MoE capacity queues, and "
            "the draft would drop different tokens than training"
        )
    if not 1 <= draft_layers <= c.n_layers:
        raise ValueError(f"draft_layers must be in [1, {c.n_layers}], got {draft_layers}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    # The last round's verify window may reach draft_len - 1 slots past
    # the final committed position before truncation.
    _check_window(c, prompt_len, steps + draft_len, "prompt_len")
    dc = dataclasses.replace(c, n_layers=draft_layers)
    prefill_full = _build_prefill(c, prompt_len, None, mesh)
    sampled = temperature > 0.0
    k = draft_len
    place = _place(mesh)

    def argmax(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def run(params, prompt, key=None):
        _key_or_raise(sampled, key, "fn(params, prompt, key)")
        B = prompt.shape[0]
        dev = prompt.device
        # On a mesh the logits and every per-row decision below are the
        # rows of the rank's fsdp group; tok, drafted, fed and outbuf
        # are global.
        rows = _rows(place, B)

        def categorical(key, logits):
            return _categorical(key, logits / temperature, rows).to(torch.int32)

        def group(x):
            return x if rows is None else rows.group(x)

        def forward(params, tokens, cache, p0, cfg):
            if rows is None:
                return decode_forward(params, tokens, cache, p0, cfg)
            return _forward(params, tokens, cache, p0, cfg, rows)

        def residual(key, target_logits, draft_logits):
            if rows is None:
                return residual_sample(key, target_logits, draft_logits, temperature)
            return residual_sample(key, target_logits, draft_logits, temperature, rows)

        dparams = draft_params(params, draft_layers)
        cache = init_cache(c, B, kv_int8, device=dev, mesh=mesh)
        last, cache = prefill_full(params, prompt, cache)
        # The draft's prefill state is free: its blocks are the full
        # model's first layers on the same inputs, so its cache is a copy
        # of the full cache's first draft_layers layers.
        dcache = _leading(cache, draft_layers, copy=True)
        if sampled:
            key, k0 = prng.split(torch.as_tensor(key, dtype=torch.int64, device=dev))
            tok = _to_global(categorical(k0, last), rows)
        else:
            tok = _to_global(argmax(last), rows)
        fin = torch.isfinite(last).all()
        outbuf = torch.zeros((B, steps + k), dtype=torch.int32, device=dev)
        count = rounds = 0
        while count < steps:
            f = prompt_len + count  # cache slot of the next fed token
            if sampled:
                key, kd, ka, kr, kb = prng.split(key, 5)
                dkeys = prng.split(kd, k + 1)
            # Draft k candidates through the shallow stack.  k + 1 steps
            # feed [tok, d1..dk]: the last output is dropped, but d_k must
            # pass through the draft so its cache holds slot f + k, which a
            # full-acceptance round commits.
            t, drafted, dlogits = tok, [], []
            for j in range(k + 1):
                lg, dcache = forward(dparams, t[:, None], dcache, f + j, dc)
                row = lg[:, -1]
                t = _to_global(categorical(dkeys[j], row) if sampled else argmax(row), rows)
                drafted.append(t)
                dlogits.append(row)
            drafted = torch.stack(drafted[:k], dim=1)  # (B, k): d1..dk
            fed = torch.cat([tok[:, None], drafted], dim=1)  # (B, k + 1)
            # One full-model pass scores every fed token: logits[:, j] is
            # the target after fed[:, j]; full agreement commits k + 1.
            logits, cache = forward(params, fed, cache, f, c)
            fin = fin & torch.isfinite(logits).all()
            if sampled:
                dlog = torch.stack(dlogits[:k], dim=1)  # (B, k, V)
                u = group(prng.uniform(ka, (B, k)))
                a = acceptance_flags(u, logits[:, :k], dlog, group(drafted), temperature)
                fin = fin & torch.isfinite(dlog).all()
            else:
                g = argmax(logits)
                a = group(fed)[:, 1:] == g[:, :-1]  # (B, k)
            # Write all k + 1 fed tokens at the frontier; the unaccepted
            # tail is overwritten by the next round.
            outbuf[:, count:count + k + 1] = fed
            # The batch consensus over every row: the round's one host sync.
            accepted = _to_global(torch.cumprod(a.to(torch.int32), dim=-1).sum(-1), rows)
            n_acc = int(accepted.min())
            if sampled:
                # Full acceptance: the bonus draw from the target after
                # d_k.  Rejection at the cut: the residual draw.  A row
                # whose acceptance ran past the cut defers its accepted
                # token, itself a target sample, to the next round.
                jstar = min(n_acc, k - 1)
                if n_acc == k:
                    tok = categorical(kb, logits[:, k])
                else:
                    resid = residual(kr, logits[:, jstar], dlog[:, jstar])
                    tok = torch.where(a[:, jstar], group(drafted)[:, jstar], resid)
            else:
                tok = g[:, n_acc]  # the target's pick after the last commit
            tok = _to_global(tok, rows)
            count += 1 + n_acc
            rounds += 1
        if rows is not None:
            fin = rows.all_true(fin)
        tokens = torch.cat([prompt.to(torch.int32), outbuf[:, :steps]], dim=1)
        return (tokens, rounds, fin) if with_stats else tokens

    return run
