"""Serving launcher of the port (port of :mod:`repro.launch.serve`):
continuous-batching generation with EMT analog or bit-serial inference on
the card.

    python -m repro_torch.launch.serve --arch gemma3-1b --smoke --mode analog \\
        --requests 8 --stagger 2 --temperature 0.8 --top-k 40

It takes the JAX launcher's flags, as thin aliases over
:class:`~repro_torch.serve.spec.ServeSpec` (``--device`` names the EMT
corner, as there).  The command line always runs on the card; a program
passes ``main(argv, torch_device="cpu")`` to run the plain PyTorch path on
the CPU.  With ``--rate R`` the engine is driven through
:class:`~repro_torch.serve.server.StreamingServer` with open-loop Poisson
arrivals and TTFT / inter-token latency are reported; otherwise requests
arrive every ``--stagger`` steps.  It reports tokens/s, the modeled EMT
energy per token, and per request the done reason and first tokens.
Speculation (``--draft-placement``) and ``--shards`` above 1 raise: they
are ported with later slices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import PLACEMENTS
from repro_torch.models import lm
from repro_torch.models.attention import paged_attn_plan
from repro_torch.serve.engine import GenRequest, prefill_bucket
from repro_torch.serve.spec import PAGED_ATTN_IMPLS, REFERENCE_ARCHS, ServeSpec


def print_attn_paths(cfg):
    """Per-layer paged decode-attention path, grouped into runs of equal
    resolutions."""
    plan = paged_attn_plan(cfg)
    if not plan:
        return
    print(f"paged attention paths ({len(plan)} layers):")
    run = []
    for path, res in plan + [("", "")]:
        if run and res != run[0][1]:
            first, last = run[0][0], run[-1][0]
            span = first if len(run) == 1 else f"{first} .. {last}"
            print(f"  {span:56s} -> {run[0][1]} x{len(run)}")
            run = []
        if path:
            run.append((path, res))


def print_plan(cfg):
    """Resolved per-layer device plan, grouped into runs of equal corners."""
    plan = cfg.placement_plan()
    print(f"device plan ({len(plan)} placement sites):")
    run = []
    for path, corner, mode in plan + (("", "", ""),):
        if run and (corner, mode) != (run[0][1], run[0][2]):
            first, last = run[0][0], run[-1][0]
            span = first if len(run) == 1 else f"{first} .. {last}"
            print(f"  {span:56s} -> {run[0][1]} ({run[0][2]}) x{len(run)}")
            run = []
        if path:
            run.append((path, corner, mode))


def spec_from_args(args) -> ServeSpec:
    """The launcher's flags as the shared :class:`ServeSpec`."""
    return ServeSpec(
        arch=args.arch, mode=args.mode, device=args.device,
        placement=args.placement, smoke=args.smoke,
        # speculation needs an all-global stack: the launcher coerces it
        all_global=bool(args.draft_placement),
        batch_size=args.batch,
        max_len=prefill_bucket(args.prompt_len) + args.max_new,
        seed=args.seed, frozen_noise=args.frozen_noise,
        paged=args.paged, block_size=args.block_size,
        num_blocks=args.kv_blocks, num_ring_blocks=args.kv_ring_blocks,
        fused_paged_attn=args.fused_paged_attn,
        paged_attn_impl=args.paged_attn_impl,
        chunked_prefill=args.chunked_prefill,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache,
        draft_placement=args.draft_placement, spec_k=args.spec_k,
        energy_budget_uj=args.energy_budget_uj,
        step_budget_uj=args.step_budget_uj,
        shards=args.shards, max_pending=args.max_pending,
        deadline_s=args.deadline_s,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id)


def serve_streaming(eng, reqs, *, rate, deadline_s, max_pending, seed=0,
                    on_handle=None):
    """Drive `eng` through the streaming front end with open-loop Poisson
    arrivals; returns (results, wall_s, rejected, ttft_s, itl_s), the
    results in the order the requests were accepted.  `on_handle(i,
    handle)`, if given, is called on the submitting thread after request
    `i` was accepted."""
    from repro_torch.serve.scheduler import RejectedError
    from repro_torch.serve.server import StreamingServer

    rng = np.random.default_rng(seed)
    handles, rejected = [], 0
    with StreamingServer(eng, max_pending=max_pending) as srv:
        t0 = time.monotonic()
        at = 0.0
        for i, r in enumerate(reqs):
            at += rng.exponential(1.0 / rate)
            delay = t0 + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            try:
                h = srv.submit(r, deadline_s=deadline_s)
            except RejectedError:
                rejected += 1
                continue
            handles.append(h)
            if on_handle is not None:
                on_handle(i, h)
        results = [h.result(timeout=600) for h in handles]
        wall = time.monotonic() - t0
    ttft = [h.ttft_s for h in handles if h.ttft_s is not None]
    itl = [d for h in handles for d in h.itl_s]
    return results, wall, rejected, ttft, itl


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=list(REFERENCE_ARCHS),
                    default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--mode", default="analog",
                    choices=["ideal", "analog", "bitserial"])
    ap.add_argument("--device", default=None,
                    help="registered technology corner for all layers "
                         "(pcm, rram, mlc2, mlc4, sram_digital, ...)")
    ap.add_argument("--placement", default=None, choices=list(PLACEMENTS),
                    help="heterogeneous per-layer placement preset "
                         "(overrides --mode/--device: the placement names "
                         "mode and corner per layer)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: --batch)")
    ap.add_argument("--stagger", type=int, default=0,
                    help="submit one request every K steps (0 = all upfront)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frozen-noise", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="paged block-table KV cache")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--kv-blocks", type=int, default=None)
    ap.add_argument("--kv-ring-blocks", type=int, default=None)
    ap.add_argument("--fused-paged-attn", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="paged decode through the fused kernel (default on); "
                         "--no-fused-paged-attn forces the gather fallback")
    ap.add_argument("--paged-attn-impl", default="auto",
                    choices=list(PAGED_ATTN_IMPLS),
                    help="kept for the JAX launcher's spec files; the port "
                         "accepts only auto (it dispatches on the device)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens admitted per mixed prefill+decode "
                         "step (chunked prefill)")
    ap.add_argument("--chunked-prefill", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="force chunked prefill on/off (default: auto — on "
                         "for decoder-only attention stacks)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prefix caching over the paged pool "
                         "(requires --paged + all-global attention)")
    ap.add_argument("--draft-placement", default=None,
                    help="speculative decoding: registered corner for the "
                         "draft placement (e.g. sram_digital); greedy-only")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--energy-budget-uj", type=float, default=None,
                    help="per-request energy SLA in uJ (exceeded -> shed "
                         "with done_reason='energy_budget')")
    ap.add_argument("--step-budget-uj", type=float, default=None,
                    help="per-engine rolling admission budget in uJ/step")
    ap.add_argument("--shards", type=int, default=1,
                    help="data-parallel shard count")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="streaming front end: open-loop Poisson arrival "
                         "rate in req/s (0 = synchronous --stagger serving)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline for --rate mode")
    ap.add_argument("--max-pending", type=int, default=16,
                    help="admission-queue bound for --rate mode")
    return ap


def main(argv=None, *, torch_device="cuda"):
    ap = _parser()
    args = ap.parse_args(argv)
    dev = resolve_device(torch_device)
    try:
        spec = spec_from_args(args)
        cfg = spec.build_config()
    except ValueError as e:
        ap.error(str(e))
    print_plan(cfg)
    if args.paged:
        print_attn_paths(cfg)
    params = lm.init_model_params(cfg, 0, device=dev)
    n_req = args.requests or args.batch
    eng = spec.build_engine(cfg, params, torch_device=dev)
    controller = eng.controller
    print(f"prefill path: "
          f"{'chunked (exact positions, mixed step)' if eng.chunked else 'legacy (batch-1 pow2 buckets)'}"
          + (f", chunk={eng.prefill_chunk}, prefix_cache=on"
             if eng.prefix_cache else
             (f", chunk={eng.prefill_chunk}" if eng.chunked else "")))
    rng = np.random.default_rng(0)
    reqs = [GenRequest(prompt=rng.integers(0, cfg.vocab_size,
                                           size=args.prompt_len).astype(np.int32),
                       max_new=args.max_new, temperature=args.temperature,
                       top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id,
                       seed=i, energy_budget_uj=args.energy_budget_uj)
            for i in range(n_req)]

    if args.rate > 0:
        results, dt, rejected, ttft, itl = serve_streaming(
            eng, reqs, rate=args.rate, deadline_s=args.deadline_s,
            max_pending=args.max_pending, seed=args.seed)
        p = lambda xs, q: np.percentile(np.asarray(xs) * 1e3, q)  # noqa: E731
        if ttft:
            print(f"streaming @ {args.rate:g} req/s: TTFT p50 "
                  f"{p(ttft, 50):.1f} ms / p99 {p(ttft, 99):.1f} ms"
                  + (f", inter-token p50 {p(itl, 50):.1f} ms / p99 "
                     f"{p(itl, 99):.1f} ms" if itl else ""))
        if rejected:
            print(f"rejected at admission (queue full): {rejected}")
    else:
        t0 = time.time()
        results = eng.serve(reqs, stagger=args.stagger)
        dt = time.time() - t0

    tok_count = sum(len(r.tokens) for r in results)
    total_uj = sum(r.energy_pj for r in results) * 1e-6
    print(f"served {len(results)} requests / {tok_count} tokens in {dt:.2f}s "
          f"({tok_count/dt:.1f} tok/s), EMT energy {total_uj:.3f} uJ "
          f"({total_uj/max(tok_count,1):.4f} uJ/token)")
    if eng.kv_reads_total:
        print(f"decode KV reads: {eng.kv_reads_total:.3g} elements "
              f"({eng.kv_reads_total/max(tok_count,1):.3g}/token; "
              f"mask-visible positions only — masked/padded positions "
              f"are free)")
    if eng.chunked:
        line = f"prefill tokens computed: {eng.prefill_tokens_total}"
        if eng.prefix_cache:
            line += (f", served from prefix cache: "
                     f"{eng.cached_prefix_tokens} "
                     f"(hits {eng.kv.prefix_hits}, "
                     f"evictions {eng.kv.prefix_evictions}, "
                     f"{eng.kv.pool_g.num_cached} blocks parked)")
        print(line)
    for r in results[:4]:
        per_tok = r.energy_pj * 1e-6 / max(len(r.tokens), 1)
        print(f"  req{r.rid}: {len(r.tokens)} toks, {per_tok:.4f} uJ/token, "
              f"{r.done_reason}: {r.tokens[:6].tolist()}")
    if controller is not None:
        print(f"control plane: shed {controller.shed} on request budgets, "
              f"deferred {controller.deferred_steps} admissions on the "
              f"engine bucket")
    if eng.corner_energy_pj:
        from repro_torch.analysis.report import corner_table
        print("per-corner energy:")
        print(corner_table(eng.corner_energy_pj, tokens=tok_count))


if __name__ == "__main__":
    main()
