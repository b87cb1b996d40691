"""Deterministic fault injection and the recovery primitives that answer
it (counterpart of the reference's `faults.py`).

The C reference has no failure handling: a NaN, a bad read or a killed
rank loses the whole run. Here, as in the JAX package, failure is a
tested input, in two halves.

Injection: a fault plan is a list of named faults, each bound to a hook
SITE ("train.step", "train.batch", "ckpt.pre_rename", ...) and a trigger
VALUE (the step or save the host code passes when it reaches the site).
The trainers and the checkpoint writer carry explicit hooks (`faults=`
arguments, built from `--fault-plan`), so tests inject without
monkeypatching. Kinds:

- ``crash``   raise InjectedCrash at the site (a simulated process death;
              the supervisor treats it as any crash)
- ``io``      raise InjectedIOError (an OSError) at the site
- ``nan``     poison the CNN trainer's float batch with NaNs
              (`poison_batch`; the LM's token batches cannot carry one,
              its guard sees organic non-finite losses)
- ``preempt`` a simulated scheduler SIGTERM: the trainer's
              PreemptionGuard flags it, the run finishes the in-flight
              step, snapshots through the atomic checkpoint path and
              exits Preempted (code 75)
- ``squeeze`` steal pages of the serving engine's pool for a window of
              ticks, ``slow`` stall one tick (`serve/engine.py` `run`,
              fired at "serve.tick" with the iteration index, where
              crash and io raise too)
- ``kv_corrupt`` flip the CRC stamp of one host-tier spill ("tier.spill",
              polled with the spill sequence), of one page of the Nth
              prefill-to-decode handoff ("fleet.handoff", ``page=K``) or
              of the Nth resume re-dispatch's committed context
              ("fleet.resume"): the check refuses it and the request
              re-prefills
- the fleet's kinds, polled by `serve/fleet.py` at "fleet.tick" with the
  fleet tick: ``replica_crash`` stops replica ``replica=K``
  (``zombie_ticks=N`` keeps it stepping as a partitioned zombie whose
  commits the router's fences refuse), ``replica_join`` adds
  ``replicas=N`` replicas, ``replica_leave`` drains replica K,
  ``pool_crash`` stops every live replica of ``pool=prefill|decode``;
  ``handoff_drop`` at "fleet.handoff" (the handoff sequence number)
  drops one KV transfer in flight; ``msg_drop`` / ``msg_dup`` /
  ``msg_delay`` at "fleet.transport" (the tick) arm a one-shot effect on
  the next matching message of the fleet's bus (``kind=``, ``replica=``,
  ``count=`` filters; ``ticks=`` for a delay), and ``partition`` cuts
  replica K off the bus for ``ticks`` ticks.

Recovery: `supervise()` is the `--max-restarts N` loop: it runs one
training attempt and, on a crash, runs another that resumes from the
latest valid checkpoint, up to N times. A world of several spawned ranks
is supervised from its parent process (`train.ranks.supervise_world`):
an attempt is a whole world, the ranks report what failed and which
planned faults fired, and the next world starts with those marked
fired. With the step-exact resume (the
epoch order and the LM's windows are functions of the seed and the
step), a crashed and restarted run ends bit for bit where the
uninterrupted run ends.

Every fired fault, restart and recovery is a ``fault`` record of the
trainer's MetricsLogger.
"""

from __future__ import annotations

import dataclasses
import random
import signal as _signal
import threading
import time
from collections.abc import Callable, Iterable

import numpy as np

from .utils.retry import backoff_delay


class InjectedFault(RuntimeError):
    """Base class of the exceptions injected faults raise: tells them
    apart from real bugs."""


class InjectedCrash(InjectedFault):
    """Simulated process death at a hook point (`site`)."""

    def __init__(self, msg: str, site: str = ""):
        super().__init__(msg)
        self.site = site


class InjectedIOError(OSError):
    """Simulated IO failure at a hook point (`site`; an OSError, so it
    travels the paths a real disk error would)."""

    def __init__(self, msg: str, site: str = ""):
        super().__init__(msg)
        self.site = site


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: `kind` fires when the host code reaches hook
    `site` with trigger value `at` (each fault fires exactly once)."""

    kind: str
    site: str
    at: int
    args: dict = dataclasses.field(default_factory=dict)

    def arg(self, name: str, default=None):
        return self.args.get(name, default)


KINDS = ("crash", "io", "nan", "squeeze", "slow", "preempt",
         "replica_crash", "replica_join", "replica_leave",
         "pool_crash", "handoff_drop", "kv_corrupt",
         "msg_drop", "msg_dup", "msg_delay", "partition")

# The hook sites each command surface registers, and the kinds each
# site's consumer applies: a plan naming a site the command never
# reaches would silently never fire, and a kind the site ignores would
# fire and do nothing; `validate_plan_sites` makes both parse-time
# errors. crash/io are legal at every fired site (`FaultInjector.fire`
# raises them). Only the CNN trainer fires train.batch, so
# nan@train.batch is an error on `lm`.
SITES: dict[str, dict[str, frozenset[str]]] = {
    "train": {
        "train.batch": frozenset({"crash", "io", "nan"}),
        "train.step": frozenset({"crash", "io", "preempt"}),
        "ckpt.pre_rename": frozenset({"crash", "io"}),
        "ckpt.manifest": frozenset({"crash", "io"}),
    },
    "train-lm": {
        "train.step": frozenset({"crash", "io", "preempt"}),
        "ckpt.pre_rename": frozenset({"crash", "io"}),
        "ckpt.manifest": frozenset({"crash", "io"}),
    },
    "serve-bench": {
        "serve.tick": frozenset({"crash", "io", "squeeze", "slow"}),
        "tier.spill": frozenset({"kv_corrupt"}),
    },
    "fleet-bench": {
        "fleet.tick": frozenset({"crash", "io", "replica_crash",
                                 "replica_join", "replica_leave",
                                 "pool_crash"}),
        "fleet.handoff": frozenset({"handoff_drop", "kv_corrupt"}),
        "fleet.resume": frozenset({"kv_corrupt"}),
        "tier.spill": frozenset({"kv_corrupt"}),
        "fleet.transport": frozenset({"msg_drop", "msg_dup",
                                      "msg_delay", "partition"}),
    },
}


def fault_plan_arg(surface: str):
    """argparse `type=` factory for --fault-plan: the grammar and the
    surface's sites and kinds checked at parse time (exit 2)."""
    def check(spec: str):
        import argparse

        try:
            validate_plan_sites(parse_plan(spec), surface)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from e
        return spec
    return check


def validate_plan_sites(plan: list[Fault] | str, surface: str) -> None:
    """Raise ValueError if a fault of `plan` targets a site that
    `surface` does not register, or a kind that site never applies."""
    if isinstance(plan, str):
        plan = parse_plan(plan)
    allowed = SITES.get(surface)
    if allowed is None:
        raise ValueError(
            f"unknown fault surface {surface!r} "
            f"(known: {', '.join(sorted(SITES))})"
        )
    bad = sorted({f.site for f in plan if f.site not in allowed})
    if bad:
        raise ValueError(
            f"fault site(s) {', '.join(bad)} are never reached by "
            f"{surface!r} (its sites: {', '.join(sorted(allowed))}) — "
            "the fault would silently never fire"
        )
    for f in plan:
        if f.kind not in allowed[f.site]:
            raise ValueError(
                f"fault kind {f.kind!r} is never applied at {f.site} "
                f"(its kinds: {', '.join(sorted(allowed[f.site]))}) — "
                "the fault would fire and silently do nothing"
            )


def parse_plan(spec: str) -> list[Fault]:
    """Parse a fault-plan spec into a list of Faults.

    Grammar: faults are ';'-separated, each ``kind@site:at`` with
    optional ``?key=val&key=val`` args (ints and floats parsed, anything
    else kept as a string)::

        crash@train.step:6
        nan@train.batch:3;crash@train.step:6
        squeeze@serve.tick:2?pages=4&ticks=8

    Raises ValueError naming the offending fragment."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, argstr = part.partition("?")
        try:
            kind, _, rest = head.partition("@")
            site, _, at = rest.rpartition(":")
            fault = Fault(kind=kind.strip(), site=site.strip(),
                          at=int(at), args=_parse_args(argstr))
        except ValueError as e:
            raise ValueError(
                f"bad fault spec {part!r} (want kind@site:at[?k=v&k=v]): {e}"
            ) from e
        if fault.kind not in KINDS:
            raise ValueError(
                f"bad fault spec {part!r}: unknown kind {fault.kind!r} "
                f"(want one of {KINDS})"
            )
        if not fault.site:
            raise ValueError(f"bad fault spec {part!r}: empty site")
        faults.append(fault)
    return faults


def format_fault(f: Fault) -> str:
    """One fault back in the ``kind@site:at?k=v&k=v`` grammar, args in
    sorted key order (equal Faults spell identically)."""
    head = f"{f.kind}@{f.site}:{f.at}"
    if not f.args:
        return head
    return head + "?" + "&".join(f"{k}={f.args[k]}" for k in sorted(f.args))


def format_plan(plan: list[Fault]) -> str:
    """A plan as the ';'-joined --fault-plan string:
    parse_plan(format_plan(p)) == p."""
    return ";".join(format_fault(f) for f in plan)


def _parse_args(argstr: str) -> dict:
    args: dict = {}
    for kv in argstr.split("&"):
        if not kv:
            continue
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"bad fault arg {kv!r} (want key=val)")
        try:
            args[k] = int(v)
        except ValueError:
            try:
                args[k] = float(v)
            except ValueError:
                args[k] = v
    return args


class FakeClock:
    """A manually advanced clock of the time.perf_counter call shape."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


# The "preempted, resumable" exit code (BSD EX_TEMPFAIL): the run
# snapshotted and wants a relaunch with --resume.
EXIT_PREEMPTED = 75


class Preempted(SystemExit):
    """Raised by a trainer after a preemption notice (SIGTERM/SIGINT or
    an injected ``preempt`` fault) once the in-flight step finished. A
    SystemExit, so `supervise` passes it through: the relaunch happens
    on the next placement, with --resume. The code is 75 only when a
    snapshot landed (resumable); 1 otherwise."""

    def __init__(self, msg: str = "preempted", *, resumable: bool = True):
        super().__init__(EXIT_PREEMPTED if resumable else 1)
        self.msg = msg
        self.resumable = resumable

    def __str__(self) -> str:  # SystemExit.__str__ shows the code only
        return self.msg


def drain_preemption(guard: PreemptionGuard, *, state, global_step: int,
                     ckpt, metrics, logger) -> None:
    """The orderly preemption exit of both trainers: nothing unless the
    guard is flagged; else snapshot `state` through the atomic,
    checksummed path (`ckpt`, an AsyncCheckpointer, or None), wait for it
    to land, log it and raise Preempted. Called at step or chunk
    boundaries only. A save already issued for this step is not
    repeated. Without a checkpointer the exit is orderly but not
    resumable (exit 1)."""
    if not guard.requested:
        return
    snapshotted = ckpt is not None
    if snapshotted:
        if ckpt.last_step != global_step:
            ckpt.save(state, global_step)
        ckpt.wait()  # durable before the process exits
        metrics.log("ckpt", step=global_step, reason="preempt")
    else:
        logger.warning(
            "preempted with no --checkpoint-dir: progress up to step "
            "%d is lost", global_step,
        )
    metrics.log("fault", kind="preempt", step=global_step,
                signum=guard.signum, resumable=snapshotted)
    if snapshotted:
        logger.warning(
            "preempted at step %d: snapshot written, exiting %d "
            "(resume with --resume)", global_step, EXIT_PREEMPTED,
        )
    raise Preempted(f"preempted at step {global_step}",
                    resumable=snapshotted)


class PreemptionGuard:
    """Deferred-preemption flag shared by the signal handler, the fault
    injector and the trainer's loop. The handler and the injector only
    set it; the trainer polls it at step (or chunk) boundaries, where
    the state is consistent, and drains (`drain_preemption`). install()
    hooks SIGTERM and SIGINT; a second signal during the drain goes to
    the previous handler, so a stuck drain stays killable. A context
    manager, so handlers do not leak."""

    def __init__(self):
        self.requested = False
        self.signum: int | None = None
        self._prev: dict[int, object] = {}

    def request(self, signum: int | None = None) -> None:
        self.requested = True
        if self.signum is None:
            self.signum = signum

    def _handle(self, signum, frame) -> None:
        if self.requested:
            self.uninstall()
            _signal.raise_signal(signum)
            return
        self.request(signum)

    def install(self, signals=(_signal.SIGTERM, _signal.SIGINT)
                ) -> PreemptionGuard:
        for s in signals:
            try:
                self._prev[s] = _signal.signal(s, self._handle)
            except ValueError:
                # Not the main thread: injected preempt faults still
                # work, OS signals do not reach this guard.
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            _signal.signal(s, prev)
        self._prev.clear()

    def __enter__(self) -> PreemptionGuard:
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class FaultInjector:
    """Deterministic dispenser of a fault plan.

    Host code calls `poll(site, value)` (the matching unfired faults,
    now marked fired) or `fire(site, value)` (the same, but crash and io
    raise at once). Each fault fires at most once and the injector is
    shared across the attempts of a supervised run, so a restarted
    attempt does not trip the crash that ended the last one; a world of
    ranks, rebuilt in new processes for each attempt, hands its ranks the
    plan indices that fired before (`fired`). `events`
    gathers one record per fired fault; the trainers drain it into
    their MetricsLogger (the injector also runs in the checkpoint
    writer's thread, hence the lock)."""

    def __init__(self, plan: list[Fault] | str | None = None, *,
                 clock: FakeClock | None = None,
                 sleep_fn: Callable[[float], None] | None = None,
                 fired: Iterable[int] = ()):
        if isinstance(plan, str):
            plan = parse_plan(plan)
        self.plan = list(plan or ())
        self.clock = clock
        self._sleep_fn = sleep_fn
        self._fired: set[int] = set(fired)
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def poll(self, site: str, value: int) -> list[Fault]:
        """Unfired faults matching (site, value), marked fired."""
        hits = []
        with self._lock:
            for i, f in enumerate(self.plan):
                if i in self._fired or f.site != site or f.at != int(value):
                    continue
                self._fired.add(i)
                # An arg named like one of the record's own keys rides
                # along prefixed instead of overwriting it.
                reserved = ("kind", "site", "at", "event", "t", "mode",
                            "schema")
                self.events.append({
                    "kind": f"injected_{f.kind}", "site": site,
                    "at": int(value),
                    **{(f"arg_{k}" if k in reserved else k): v
                       for k, v in f.args.items()},
                })
                hits.append(f)
        return hits

    def fired(self) -> tuple[int, ...]:
        """The plan indices that fired (or came in as `fired`), sorted."""
        with self._lock:
            return tuple(sorted(self._fired))

    def pending(self, site: str, kind: str | None = None) -> list[Fault]:
        """Unfired faults at `site` (of `kind`, if given), in plan
        order."""
        with self._lock:
            return [f for i, f in enumerate(self.plan)
                    if i not in self._fired and f.site == site
                    and (kind is None or f.kind == kind)]

    def fire(self, site: str, value: int) -> list[Fault]:
        """poll(), then raise for crash and io; the other kinds are
        returned for the caller to apply."""
        soft = []
        for f in self.poll(site, value):
            if f.kind == "crash":
                raise InjectedCrash(f"injected crash at {site}:{value}",
                                    site)
            if f.kind == "io":
                raise InjectedIOError(
                    f"injected IO error at {site}:{value}", site)
            soft.append(f)
        return soft

    def sleep(self, seconds: float) -> None:
        """A slow fault's stall: advances the FakeClock when one is
        attached, else sleeps."""
        if self.clock is not None:
            self.clock.advance(seconds)
        elif self._sleep_fn is not None:
            self._sleep_fn(seconds)
        else:
            time.sleep(seconds)

    def drain_events(self) -> list[dict]:
        with self._lock:
            ev, self.events = self.events, []
        return ev


def poison_batch(x: np.ndarray, fault: Fault) -> np.ndarray:
    """Apply a ``nan`` fault to a host batch: NaN in its first `rows`
    rows (1 unless the fault says otherwise), so that the guard's
    detection, not the injection, does the work."""
    x = np.array(x, dtype=np.float32, copy=True)
    rows = int(fault.arg("rows", 1))
    x[:rows] = np.nan
    return x


class NonFiniteLossError(RuntimeError):
    """Raised by --nan-policy=abort when a step's metrics or its updated
    state are not finite."""


class RollbackToCheckpoint(Exception):
    """Raised inside a trainer's loop when --nan-policy=restore meets
    `max_bad` non-finite steps in a row: the trainer reloads the latest
    valid checkpoint and re-enters at its step."""


# After this many nan-policy=restore rollbacks a run raises instead of
# looping: a NaN that reproduces must surface.
MAX_NAN_ROLLBACKS = 5


class NanGuard:
    """The NaN/Inf guard's policy, shared by both trainers: "off",
    "abort" (raise on the first bad step), "skip" (drop the bad update,
    go on) or "restore" (skip, then RollbackToCheckpoint after `max_bad`
    bad steps in a row)."""

    def __init__(self, policy: str, max_bad: int = 3):
        if policy not in ("off", "abort", "skip", "restore"):
            raise ValueError(
                f"--nan-policy {policy!r}: want off|abort|skip|restore"
            )
        self.policy = policy
        self.max_bad = max_bad
        self.streak = 0   # non-finite steps in a row
        self.skipped = 0  # dropped updates (skip/restore)

    @property
    def active(self) -> bool:
        return self.policy != "off"

    @property
    def snapshots(self) -> bool:
        """Whether the pre-step state must be kept (skip and restore drop
        a bad update by putting it back)."""
        return self.policy in ("skip", "restore")

    def step_ok(self) -> None:
        self.streak = 0

    def bad_step(self, step: int, *, logger, metrics) -> None:
        """Record a non-finite step and apply the policy: raises
        NonFiniteLossError for abort and RollbackToCheckpoint when
        restore reaches max_bad; returns for a skip, and the caller puts
        back its pre-step state with the step counter advanced."""
        self.streak += 1
        metrics.log("fault", kind="nonfinite_step", step=step,
                    policy=self.policy, streak=self.streak)
        if self.policy == "abort":
            raise NonFiniteLossError(
                f"step {step}: non-finite loss/metrics or state "
                "(--nan-policy=abort)"
            )
        self.skipped += 1
        logger.warning(
            "step %d: non-finite update dropped (%s, streak %d)",
            step, self.policy, self.streak,
        )
        if self.policy == "restore" and self.streak >= self.max_bad:
            raise RollbackToCheckpoint


def all_finite(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One device flag, 0.0 when every floating tensor of `tensors` is
    finite (integer tensors always are), else 1.0. One multi-tensor
    launch per device and dtype: PyTorch's AMP check, which scales every
    tensor in place by its `inv_scale`, here exactly 1 (a bitwise no-op:
    x * 1.0 == x for every finite x, -0.0 included)."""
    # Imported here: only the trainers call this, and the module itself
    # stays torch-free for the tools that read fault plans.
    import torch  # mctpu: disable=MCT001

    floats = [t for t in tensors if t.is_floating_point()]
    with torch.no_grad():
        found = torch.zeros(1, device=floats[0].device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            floats, found, torch.ones(1, device=found.device))
    return found


def step_is_finite(metrics: torch.Tensor, tensors: list[torch.Tensor]
                   ) -> bool:
    """The guard's check of one step: the step's metrics and every tensor
    of the updated state (params and optimizer moments: a NaN gradient
    with a finite loss lands there) are finite. One device check
    (`all_finite`), then one host sync."""
    return not all_finite([metrics.detach().reshape(-1), *tensors]).item()


# What the supervisor never restarts: the operator's interrupt, an exit
# (Preempted among them: an eviction is answered by a relaunch, not a
# retry) and the NaN guard's verdict (an organic NaN replays from the
# checkpoint).
PASS_THROUGH = (KeyboardInterrupt, SystemExit, NonFiniteLossError)


def supervise(attempt_fn: Callable[[int], object], *, max_restarts: int,
              logger=None, metrics=None, registry=None,
              backoff_base: float = 0.5,
              # injectable U[0,1) default: tests pass a constant
              # mctpu: disable=MCT004
              sleep=time.sleep, jitter=random.random,
              restartable: Callable[[BaseException], bool] | None = None
              ) -> object:
    """The crash-safe training supervisor: run `attempt_fn(attempt)` and,
    on a crash, run it again, up to `max_restarts` more times.
    `attempt_fn` gets the attempt index (0 first) and resumes from the
    latest checkpoint for attempt > 0 (the rank entries force
    cfg.resume). `PASS_THROUGH` (KeyboardInterrupt, SystemExit with
    Preempted, NonFiniteLossError) passes through. Exhausted restarts
    re-raise the last crash, as does a crash that `restartable` (None:
    every crash is) turns down: a world's parent turns down a world whose
    ranks failed in one of those ways (`train.ranks.supervise_world`). Restarts are paced by `utils.retry.backoff_delay`
    (backoff_base 0: none), each logged as a ``fault`` record
    (kind="restart") when `metrics` is given and counted as
    ``train.restarts`` in `registry` (an `obs.metrics.MetricsRegistry`,
    which outlives the attempts). `sleep` and `jitter` are injection
    points for tests."""
    last: BaseException | None = None
    for attempt in range(max_restarts + 1):
        try:
            return attempt_fn(attempt)
        except PASS_THROUGH:
            raise
        except Exception as e:  # noqa: BLE001 — a supervisor catches broadly
            last = e
            if attempt >= max_restarts or (restartable is not None
                                           and not restartable(e)):
                break
            delay = backoff_delay(attempt, backoff_base, jitter)
            if logger is not None:
                logger.warning(
                    "training attempt %d crashed (%s: %s); restarting "
                    "from the latest valid checkpoint in %.2fs "
                    "(%d restart(s) left)", attempt, type(e).__name__, e,
                    delay, max_restarts - attempt,
                )
            if registry is not None:
                registry.inc("train.restarts")
            if metrics is not None:
                metrics.log("fault", kind="restart", attempt=attempt,
                            delay_s=round(delay, 4),
                            error=f"{type(e).__name__}: {e}")
            if delay > 0:
                sleep(delay)
    assert last is not None
    raise last
