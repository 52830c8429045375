"""Chunked fused engine for steady-state DREAM-zs.

Counterpart of ``bipymc_tpu/samplers/dream_fused.py`` on one device, in
stream mode and in kernel-RNG mode: a host loop over chunks of G =
``archive_thin`` generations, each (a) a few torch ops that make the
chunk's operands from the same words as the per-generation engine
(``core/rng.StepWords``: the words of generation t depend on t alone),
draw the
distinct archive rows with kernel B3 and gather them, and pack the
per-chain scalars with the frozen CR table, then (b) ONE launch of
kernel B1 (``ops/fused_chunk.py``) for all G generations, then (c) the
archive append of the chunk's last generation.

Why G = ``archive_thin``: the per-generation engine appends to the
archive only after generation ``gen % archive_thin == archive_thin − 1``
has proposed, so the archive is constant over an aligned chunk, and
every row the chunk reads can be gathered before the kernel runs. CR
adaptation and the outlier reset stop at ``burnin_gens``, so after
burn-in the chunk's scalars depend on the words alone. The fused engine
thus takes the per-generation engine's decisions: the same words, the
same rows, the same scalars and the same math (B2's proposal and
``metropolis_select``), up to float re-association on the card.

Kernel-RNG mode (``rng="kernel"``, as ``bench.py`` runs the JAX
package): B1 draws the crossover uniforms, the multiplicative uniforms
and the normals itself (Philox keyed by the run key, the generation and
the chain), so a generation's word block shrinks from 5 + k + 3d words a
chain to 5 + k, and the chunk's decisions are no longer the
per-generation engine's: the same distributions, other draws.

The archive rows of a chunk are one gather of its [G·n, k] indices:
torch indexing (``gather_mode="block"``, the default) or kernel B11
(``gather_mode="kernel"``, ``ops/gather_rows.py``); the rows are the
same. The JAX package's ``"pergen"`` mode, G per-generation gathers
under ``lax.map`` (``bipymc_tpu/samplers/dream_fused.py:98-99``), is a
TPU lowering with no kernel of its own; it raises (ROADMAP Queue A item
18b). Its module global ``_GATHER_MODE``
(``:85``) is left behind (ROADMAP A16): the mode is an argument.

Not ported (``samplers/api.py`` raises for each, naming its ROADMAP
item): the mesh, ``z_update_every > 1`` and ``log_prob_block``. The
chunks' kernel B1 carries its own accept, so ``pallas_accept=True``
(kernel B10) reaches only the generations the per-generation engine
runs around them.
"""

from typing import Callable

import torch

from bipymc_tpu_torch.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu_torch.ensemble.archive import archive_append
from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
from bipymc_tpu_torch.ops.fused_chunk import run_fused_chunk
from bipymc_tpu_torch.ops.gather_rows import gather_rows
from bipymc_tpu_torch.samplers.dream import (DreamConfig, DreamState,
                                             n_rows, n_words)
from bipymc_tpu_torch.utils.streaming import rhat_init, rhat_update_block

_MESH_ITEM = "ROADMAP Queue A item 15 (multi-GPU)"
_PERGEN_ITEM = "ROADMAP Queue A item 18b"
GATHER_MODES = ("block", "pergen", "kernel")


def check_gather_mode(gather_mode: str) -> None:
    """``ValueError`` for an unknown mode, ``NotImplementedError`` for
    ``"pergen"``."""
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode={gather_mode!r}: expected one of "
                         f"{GATHER_MODES}")
    if gather_mode == "pergen":
        raise NotImplementedError(
            "gather_mode='pergen' (per-generation gathers, a TPU lowering "
            f"with no kernel) is not ported: {_PERGEN_ITEM}")


def validate_fused_segment(cfg: DreamConfig, t0: int):
    """Check a segment start is archive-aligned and post-burn-in."""
    G = cfg.archive_thin
    if t0 % G != 0:
        raise ValueError(f"t0={t0} not archive-aligned (thin={G})")
    if t0 < cfg.burnin_gens:
        raise ValueError(
            f"fused engine is post-burn-in only (t0={t0} < "
            f"burnin_gens={cfg.burnin_gens}); run the per-generation "
            "engine through burn-in first")


def check_fusable(cfg: DreamConfig, mesh=None):
    """Raise if the fused engine cannot reproduce this configuration."""
    if not cfg.use_archive:
        raise ValueError("fused engine requires use_archive=True "
                         "(population-DREAM gathers the live population)")
    if cfg.shard_archive:
        raise ValueError("fused engine requires a replicated archive "
                         "(shard_archive=True uses the per-generation "
                         "engine's ring path)")
    if mesh is not None:
        raise NotImplementedError(f"mesh= is not ported: {_MESH_ITEM}")


def chunk_row_idx(state: DreamState, blk, cfg: DreamConfig):
    """The chunk's archive row indices, int32 [G·n, k], drawn by B3 from
    the word block ``blk`` [G, n, ≥ 5 + k]: every generation of the chunk
    samples the chunk-start archive."""
    k = n_rows(cfg)
    return distinct_idx(blk.view(-1, blk.shape[-1])[:, 5:5 + k], k,
                        state.archive.fill)


def _rows_and_scal(state: DreamState, blk, u_all, t0: int,
                   cfg: DreamConfig, gather_mode: str = "block"):
    """The archive rows [G, n, k, d] and packed scalars [G, n, 6] of
    generations t0 … t0 + G − 1 from their word block ``blk`` [G, n, ≥ 5
    + k] and its uniforms ``u_all``, built as ``samplers/dream.py``'s
    step builds one generation's; the rows through ``gather_mode``."""
    x = state.x
    n, d = x.shape
    dtype, device = x.dtype, x.device
    G = cfg.archive_thin
    k = n_rows(cfg)
    n_pairs = cfg.delta_max
    u_scal = u_all[..., 0:3]
    u_cr = u_all[..., 3]
    row_idx = chunk_row_idx(state, blk, cfg)
    if gather_mode == "kernel":
        rows = gather_rows(state.archive.buf, row_idx).view(G, n, k, d)
    else:
        rows = state.archive.buf[row_idx].view(G, n, k, d)
    # the scalars as the step packs them, with the frozen CR table
    cr_idx = torch.clamp_max(
        torch.sum(u_cr[..., None] >= state.cr_cum, dim=-1), cfg.n_cr - 1)
    delta = torch.clamp_max(
        1.0 + torch.floor(u_scal[..., 1] * n_pairs), float(n_pairs))
    cr = (cr_idx + 1).to(dtype) / cfg.n_cr
    gamma_s = cfg.snooker_lo + \
        (cfg.snooker_hi - cfg.snooker_lo) * u_scal[..., 2]
    is_snk = (u_scal[..., 0] < cfg.p_snooker).to(dtype)
    ts = torch.arange(t0, t0 + G, device=device)
    jump = ((ts % cfg.jump_interval) == cfg.jump_interval - 1).to(dtype)
    gj = jump[:, None].expand(G, n)
    if cfg.jump_full_cr:
        cr = torch.where(gj > 0.5, 1.0, cr)
    scal = torch.stack([delta, cr, gamma_s, is_snk, gj,
                        torch.log(u_all[..., 4])], dim=-1)
    return rows, scal


def chunk_operands(state: DreamState, words, t0: int, cfg: DreamConfig,
                   gather_mode: str = "block"):
    """Kernel B1's stream-mode operands for generations t0 … t0 + G − 1
    from the chunk-start state: ``(rows [G, n, k, d], u_mask, u_e, eps
    [G, n, d], scal [G, n, 6])``, built as ``samplers/dream.py``'s step
    builds one generation's (``words`` has ``block``, as
    ``core/rng.StepWords``)."""
    n, d = state.x.shape
    off = 5 + n_rows(cfg)
    blk = words.block(t0, cfg.archive_thin, n, n_words(cfg, d),
                      state.x.device)                     # [G, n, words]
    u_all = bits_to_uniform(blk, state.x.dtype)
    rows, scal = _rows_and_scal(state, blk, u_all, t0, cfg, gather_mode)
    return (rows, u_all[..., off:off + d], u_all[..., off + d:off + 2 * d],
            uniform_to_normal(u_all[..., off + 2 * d:]), scal)


def chunk_operands_kernel_rng(state: DreamState, words, t0: int,
                              cfg: DreamConfig, test_stream_bits=False,
                              gather_mode: str = "block"):
    """Kernel B1's kernel-RNG-mode operands: ``(rows, scal, test_bits)``
    from a ``[G, n, 5 + k]`` word block; B1 draws u_mask, u_e and eps
    itself, so ``test_bits`` is None. With ``test_stream_bits`` the block
    is stream mode's, and its last 3d words of each chain become
    ``test_bits`` (``bipymc_tpu/samplers/dream_fused.py:346-351``), so
    the chunk takes stream mode's decisions."""
    n, d = state.x.shape
    blk = words.block(t0, cfg.archive_thin, n,
                      n_words(cfg, d, kernel_rng=not test_stream_bits),
                      state.x.device)
    rows, scal = _rows_and_scal(state, blk,
                                bits_to_uniform(blk[..., :5], state.x.dtype),
                                t0, cfg, gather_mode)
    test_bits = None
    if test_stream_bits:
        off = 5 + n_rows(cfg)
        test_bits = tuple(blk[..., off + j * d:off + (j + 1) * d].contiguous()
                          for j in range(3))
    return rows, scal, test_bits


def make_chunk_runner(log_prob: Callable, cfg: DreamConfig,
                      collect: str = "all", rng: str = "stream",
                      gather_mode: str = "block",
                      _test_stream_bits: bool = False) -> Callable:
    """Build ``run(state, words, n_gens, t0) -> (state, history)``.

    n_gens must be a multiple of G = ``cfg.archive_thin``; ``t0`` (the
    state's generation counter) must be a multiple of G and at least
    ``cfg.burnin_gens``. words: a word source with ``block``
    (``core/rng.StepWords``). history holds ``logp``, ``accepted`` and
    ``snooker`` ([n_gens, n]) and, with ``collect="all"``, ``x``
    ([n_gens, n, d]); ``collect="stats"`` keeps no positions;
    ``collect="rhat"`` folds them chunk by chunk into per-chain moments,
    returned as ``history["rhat"]`` (what ``ChainPool.run_until``
    merges).

    ``rng="kernel"``: kernel B1 draws u_mask, u_e and eps itself from
    Philox keyed by ``words.key`` and the generation
    (``core/rng.kernel_draw_bits``), and the chunk's word block holds
    only the 5 + k scalar and row words. ``_test_stream_bits`` (tests
    only) hands B1 stream mode's words instead, so kernel-RNG mode takes
    stream mode's decisions.

    ``gather_mode="kernel"``: the chunk's archive rows come from kernel
    B11 instead of torch indexing, in either RNG mode; the same rows, so
    the same run.
    """
    if collect not in ("all", "stats", "rhat"):
        raise ValueError(
            f"collect={collect!r}: expected 'all', 'stats' or 'rhat'")
    if rng not in ("stream", "kernel"):
        raise ValueError(f"rng={rng!r}: expected 'stream' or 'kernel'")
    check_gather_mode(gather_mode)
    check_fusable(cfg)
    G = cfg.archive_thin
    kw = dict(n_pairs=cfg.delta_max, b=cfg.b, b_star=cfg.b_star)

    def runner(state: DreamState, words, n_gens: int, t0: int):
        if n_gens % G != 0:
            raise ValueError(f"n_gens={n_gens} not a multiple of the chunk "
                             f"length archive_thin={G}")
        validate_fused_segment(cfg, t0)
        n, d = state.x.shape
        st = state
        rc = rhat_init(n, d, st.x.dtype, st.x.device)
        xs, lps, accs, snks = [], [], [], []
        for c0 in range(t0, t0 + n_gens, G):
            if rng == "kernel":
                rows, scal, tb = chunk_operands_kernel_rng(
                    st, words, c0, cfg, _test_stream_bits, gather_mode)
                xh, lph, acc = run_fused_chunk(
                    st.x, st.logp, rows, None, None, None, scal, log_prob,
                    d_true=d, rng="kernel", run_key=words.key, t0=c0,
                    test_bits=tb, **kw)
            else:
                rows, u_mask, u_e, eps, scal = chunk_operands(
                    st, words, c0, cfg, gather_mode)
                xh, lph, acc = run_fused_chunk(
                    st.x, st.logp, rows, u_mask, u_e, eps, scal, log_prob,
                    d_true=d, **kw)
            st = DreamState(
                x=xh[-1], logp=lph[-1],
                archive=archive_append(st.archive, xh[-1]),
                cr_p=st.cr_p, cr_cum=st.cr_cum, cr_jump=st.cr_jump,
                cr_count=st.cr_count,
                logp_sum=st.logp_sum + torch.sum(lph, dim=0),
                gen=st.gen + G)
            if collect == "all":
                xs.append(xh)
            elif collect == "rhat":
                rc = rhat_update_block(rc, xh)
            lps.append(lph)
            accs.append(acc)
            snks.append(scal[..., 3] > 0.5)
        hist = {"logp": torch.cat(lps), "accepted": torch.cat(accs),
                "snooker": torch.cat(snks)}
        if collect == "all":
            hist["x"] = torch.cat(xs)
        elif collect == "rhat":
            hist["rhat"] = rc
        return st, hist

    # the contract ChainPool.run_until checks at its entry: chunk lengths
    # and chunk starts are multiples of G; the history records state.x
    runner.align = G
    runner.chunk_multiple = G
    runner.position_field = "x"
    return runner
