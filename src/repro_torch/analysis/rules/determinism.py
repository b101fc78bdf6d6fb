"""A301/A302 — injected clocks and seeded RNG.

The lifecycle tests and the fault-injection harness replay
drift scenarios deterministically by injecting a fake clock and a seeded RNG;
the streaming scheduler's deadline math is only testable because time
comes in through a parameter.  A direct ``time.monotonic()`` buried in a
helper silently re-couples a subsystem to the wall clock and the replay
harness can no longer freeze it.  The rule flags *calls*, not references:
``clock: Callable[[], float] = time.monotonic`` as a parameter default is
exactly the sanctioned injection idiom.

The port's counterpart of a JAX PRNG key is an explicit ``torch.Generator``,
so A302 also flags torch's process-global generator: ``torch.manual_seed``
and ``torch.seed`` (which reseed it for everyone) and the sampling calls of
``TORCH_SAMPLERS`` without a ``generator=`` keyword."""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import rule

# Subsystems whose behavior the test harnesses replay deterministically.
CLOCKED_PACKAGES = ("core", "serving", "runtime")

WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

UNSEEDED_RANDOM_PREFIXES = ("random.",)
NUMPY_RANDOM = ("numpy.random.", "np.random.")
# torch's process-global generator: reseeding it, and sampling from it
TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                     "torch.random.seed", "torch.cuda.manual_seed",
                     "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"}
TORCH_SAMPLERS = {f"torch.{f}" for f in ("rand", "randn", "randint", "randperm", "normal",
                                        "bernoulli", "multinomial")}


def _is_call(ctx, node):
    parent = ctx.parent(node)
    return isinstance(parent, ast.Call) and parent.func is node


@rule(
    "A301",
    "no wall-clock calls in deterministic subsystems",
    "core/, serving/ and runtime/ never CALL time.time/monotonic/"
    "perf_counter(_ns), datetime.now/utcnow or date.today; time is injected "
    "(`clock: Callable[[], float] = time.monotonic` parameter defaults are "
    "references, not calls, and stay legal).",
    "take `clock: Callable[[], float] = time.monotonic` as a parameter or "
    "dataclass field and call self.clock()/clock()",
    "lifecycle replay / fault-injection determinism",
)
def wall_clock_injection(ctx):
    if not ctx.in_package(*CLOCKED_PACKAGES):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Attribute, ast.Name)) \
                and _is_call(ctx, node):
            qn = ctx.qualname(node)
            if qn in WALL_CLOCK_CALLS:
                yield node.lineno, (f"calls {qn}() — wall-clock reads must "
                                    "come through an injected clock")


@rule(
    "A302",
    "no unseeded global RNG in deterministic subsystems",
    "core/, serving/ and runtime/ never call the process-global "
    "random.*/numpy.random.*/torch state (torch.manual_seed, torch.seed, "
    "torch.rand*/normal/bernoulli/multinomial without generator=); "
    "randomness flows from an explicit random.Random(seed) / "
    "numpy.random.default_rng(seed) / torch.Generator.",
    "thread a `rng` argument (random.Random(seed), "
    "np.random.default_rng(seed) or a seeded torch.Generator passed as "
    "generator=) from the config seed",
    "seeded drift + fault schedules",
)
def seeded_rng(ctx):
    if not ctx.in_package(*CLOCKED_PACKAGES):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, (ast.Attribute, ast.Name))
                and _is_call(ctx, node)):
            continue
        qn = ctx.qualname(node)
        if qn is None:
            continue
        if qn == "random.Random" or qn.startswith("random.Random."):
            continue  # instantiating an explicit, seedable generator
        if qn in TORCH_GLOBAL_SEED:
            yield node.lineno, (f"calls {qn}() — it reseeds torch's "
                                "process-global generator; seed a "
                                "torch.Generator and pass it in")
            continue
        if qn in TORCH_SAMPLERS:
            call = ctx.parent(node)
            if not any(kw.arg == "generator" for kw in call.keywords):
                yield node.lineno, (f"calls {qn}() without generator= — "
                                    "it draws from torch's process-global "
                                    "generator")
            continue
        if any(qn.startswith(p) for p in UNSEEDED_RANDOM_PREFIXES):
            yield node.lineno, (f"calls the global RNG {qn}() — seedless "
                                "randomness breaks scenario replay")
            continue
        for p in NUMPY_RANDOM:
            if not qn.startswith(p):
                continue
            tail = qn[len(p):]
            call = ctx.parent(node)
            if tail == "default_rng" and call.args:
                break  # np.random.default_rng(seed): explicit and seeded
            yield node.lineno, (f"calls {qn}() — use "
                                "np.random.default_rng(seed) and pass the "
                                "generator in")
            break
