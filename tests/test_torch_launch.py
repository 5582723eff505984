"""The port's serving launcher (``repro_torch.launch.serve``) against
``repro.launch.serve``: the same flags, the same :class:`ServeSpec` for the
same command line, the same device plan; ``main(argv,
torch_device="cpu")`` serves a tiny run in the stagger mode and in the
Poisson (``--rate``) mode through the streaming front end and prints the
report.  Two quirks of the reference are mirrored, not fixed (ROADMAP
Queue 3): ``--smoke`` is ``store_true`` with default True, and
``--prefix-cache`` on gemma3-1b's default ring stack is refused by
``ServeSpec.build_config`` (only ``--draft-placement`` makes the launcher
all-global).
"""
import contextlib
import io
import re
import sys

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

ARGVS = [
    [],
    ["--paged", "--block-size", "8", "--prompt-len", "12", "--max-new", "5",
     "--batch", "3", "--requests", "7", "--stagger", "2", "--frozen-noise"],
    ["--placement", "mixed", "--temperature", "0.8", "--top-k", "40",
     "--top-p", "0.9", "--eos-id", "3", "--seed", "5"],
    ["--device", "rram", "--mode", "bitserial", "--no-chunked-prefill",
     "--no-fused-paged-attn", "--kv-blocks", "64", "--kv-ring-blocks", "32"],
    ["--paged", "--prefix-cache", "--prefill-chunk", "8",
     "--energy-budget-uj", "2.5", "--step-budget-uj", "0.5"],
    ["--rate", "4", "--deadline-s", "1.5", "--max-pending", "3",
     "--paged-attn-impl", "ref", "--arch", "seamless-m4t-medium"],
    ["--draft-placement", "sram_digital", "--spec-k", "3"],
    ["--shards", "2", "--batch", "4", "--paged"],
    ["--arch", "moonshot-v1-16b-a3b", "--placement", "mixed"],
]


def _jax_options() -> set:
    """The JAX launcher's option strings, from its --help."""
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["serve", "--help"]
    try:
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            jserve.main()
    finally:
        sys.argv = argv
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", out.getvalue()))


def test_flags_are_the_reference_flags():
    """The same option strings as JAX's launcher, no new ones."""
    ours = {o for o in tserve._parser()._option_string_actions
            if o.startswith("--")}
    assert ours == _jax_options()


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_spec_from_args_matches_jax(argv):
    """The same command line gives JAX's ServeSpec dict (--smoke cannot be
    turned off: store_true with default True, as in JAX)."""
    args = tserve._parser().parse_args(argv)
    assert args.smoke is True
    assert tserve.spec_from_args(args).to_dict() == \
        jserve.spec_from_args(args).to_dict()


def test_print_plan_matches_jax():
    from repro.serve.spec import ServeSpec as JSpec
    from repro_torch.serve.spec import ServeSpec as TSpec
    for kw in (dict(), dict(placement="mixed", all_global=True),
               dict(arch="moonshot-v1-16b-a3b", placement="mixed")):
        outs = []
        for spec, mod in ((JSpec(**kw), jserve), (TSpec(**kw), tserve)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                mod.print_plan(spec.build_config())
            outs.append(buf.getvalue())
        assert outs[1] == outs[0] and "device plan" in outs[1]


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(argv, torch_device="cpu")
    return buf.getvalue()


TINY = ["--batch", "2", "--requests", "3", "--prompt-len", "6",
        "--max-new", "3", "--frozen-noise", "--paged", "--block-size", "4"]


def test_main_serves_staggered_requests_on_the_cpu():
    out = _main(TINY + ["--stagger", "1"])
    assert "device plan" in out and "paged attention paths" in out
    assert "prefill path: chunked" in out
    assert re.search(r"served 3 requests / 9 tokens in [\d.]+s", out)
    assert re.search(r"prefill tokens computed: 18\b", out)
    assert len(re.findall(r"^  req\d: 3 toks, .* max_new: \[", out,
                          re.M)) == 3
    assert "per-corner energy:" in out and "| total |" in out


def test_main_streams_poisson_arrivals_on_the_cpu():
    """--rate drives the engine through StreamingServer; with an energy
    budget the control plane line is printed."""
    out = _main(TINY + ["--rate", "50", "--max-pending", "4",
                        "--energy-budget-uj", "1000000"])
    assert re.search(r"streaming @ 50 req/s: TTFT p50 [\d.]+ ms / p99 "
                     r"[\d.]+ ms, inter-token p50 [\d.]+ ms", out)
    assert re.search(r"served 3 requests / 9 tokens", out)
    assert "control plane: shed 0 on request budgets" in out


def test_main_serves_moe_on_the_mixed_placement_on_the_cpu():
    """``--arch moonshot-v1-16b-a3b --placement mixed``: the MoE stack's
    plan (experts on RRAM, routers on SRAM), the chunked path, every
    request served, energy booked on all three corners; the plan lines are
    JAX's launcher's."""
    argv = ["--arch", "moonshot-v1-16b-a3b", "--placement", "mixed"]
    out = _main(argv + TINY + ["--stagger", "1"])
    assert re.search(r"dec/layer_001/moe/experts +-> rram \(bitserial\)", out)
    assert re.search(r"dec/layer_001/moe/router +-> sram_digital \(analog\)",
                     out)
    assert "prefill path: chunked" in out
    assert re.search(r"served 3 requests / 9 tokens in [\d.]+s", out)
    for corner in ("pcm", "rram", "sram_digital"):
        assert re.search(rf"^\| {corner} \| [\d.]+ \|", out, re.M), corner
    args = tserve._parser().parse_args(argv)
    from repro.serve.spec import ServeSpec as JSpec
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.print_plan(JSpec.from_dict(
            tserve.spec_from_args(args).to_dict()).build_config())
    assert buf.getvalue() in out


def test_prefix_cache_on_the_default_ring_stack_is_refused():
    """A reference quirk, mirrored: gemma3-1b keeps its ring layers unless
    --draft-placement is given, so --paged --prefix-cache exits with the
    spec's message, as JAX's launcher does."""
    errs = []
    for run in (lambda: jserve.main(),
                lambda: tserve.main(["--paged", "--prefix-cache"],
                                    torch_device="cpu")):
        err = io.StringIO()
        argv = sys.argv
        sys.argv = ["serve", "--paged", "--prefix-cache"]
        try:
            with contextlib.redirect_stderr(err), \
                    pytest.raises(SystemExit) as exc:
                run()
        finally:
            sys.argv = argv
        assert exc.value.code == 2
        errs.append(err.getvalue().strip().splitlines()[-1])
    assert "all-global" in errs[1]
    assert errs[1].split("error: ")[1] == errs[0].split("error: ")[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_runs_on_the_card_only():
    """Without a card the command line's default device raises instead of
    falling back to the CPU."""
    with pytest.raises(RuntimeError, match="not available"):
        tserve.main(TINY)
