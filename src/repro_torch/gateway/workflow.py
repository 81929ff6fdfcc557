"""Workflow composition: chained / fan-out / fan-in invocations as ONE
submission over any gateway backend.

Single-shot ``invoke()`` and flat ``map()`` cannot express the paper's
multi-accelerator applications (a VPU image-recognition stage feeding a GPU
language stage); the Berkeley serverless critique names exactly this — poor
function composition — as a core FaaS limitation.  This module adds the
missing layer:

    wf   = Workflow("caption")
    sees = wf.fan_out("see", "vision-yolo", payloads=images)   # map
    hear = wf.step("hear", "audio-whisper", payload=audio)
    cap  = wf.step("caption", "serve-llm",
                   after=sees + [hear], retries=1)             # fan-in
    out  = gw.submit_workflow(wf).result()

Steps compile to a DAG (acyclic by construction: a step may only depend on
already-declared steps).  The :class:`WorkflowRunner` submits every step
the moment its dependencies resolve — intermediate results flow node-to-
node through the **object store** (a chained step's ``data_ref`` *is* its
parent's ``result_ref``; a fan-in step reads one combined list staged by
:meth:`ObjectStore.gather`), never through the client.

Because a chained step's ``data_ref`` is its parent's ``result_ref``, the
placement layer's data-locality scoring (``docs/scheduling.md``) can route
the child to the node that produced the parent's result and read the copy
still resident there — zero store round-trips along a chain.  Fan-in
steps are *not* locality-eligible: the gather barrier stages a fresh
combined object that is resident nowhere.  :meth:`WorkflowFuture.
locality_hits` / :meth:`WorkflowFuture.locality_rate` report how often
placement achieved this.

Two drive modes, decided by ``Backend.autonomous``:

* engine backend — a daemon driver thread per workflow reacts to
  settlements (``wait_any``); steps from many live workflows interleave
  into the dispatcher's micro-batches because ``workflow``/``step``
  provenance is *not* part of ``runtime_key``.
* sim backend — pull-driven: ``WorkflowFuture.result()`` steps the virtual
  clock just far enough to observe each completion, so scheduler and
  placement experiments over heterogeneous testbeds keep exact virtual-time
  semantics (a chained step's RStart is the instant its parent settled).

Failure semantics: per-step ``retries`` (resubmission, also covering
admission rejections), then propagation — the failing step poisons every
transitive descendant (status ``cancelled``, never submitted, so the engine
dispatcher stays drainable) and ``WorkflowFuture.result()`` raises
:class:`WorkflowStepError` naming the step.  See ``docs/workflows.md``.

Crash recovery: ``submit(wf, resume=True)`` restores steps whose outcome a
previous submission already persisted (deterministic per-step resume keys
in the object store) as DONE — only the unfinished suffix of the DAG is
recomputed.  See ``docs/reliability.md``.

The port's copy of ``repro.gateway.workflow`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core.storage import is_outcome, unwrap_outcome
from repro_torch.gateway.future import InvocationFuture

_submission_ids = itertools.count()

# step lifecycle states (strings so ``statuses()`` prints cleanly)
PENDING = "pending"        # waiting on dependencies
RUNNING = "running"        # submitted; invocation in flight (or retrying)
DONE = "done"              # settled successfully
FAILED = "failed"          # settled unsuccessfully after all retries
CANCELLED = "cancelled"    # never submitted: an upstream step failed


class WorkflowStepError(RuntimeError):
    """A workflow failed because one of its steps did.

    Carries the failing step's name (``step``), its last invocation
    (``invocation``, None when the step never reached submission), and a
    message embedding the underlying execution error.
    """

    def __init__(self, workflow: str, step: str, attempts: int,
                 invocation=None, error: Optional[str] = None):
        detail = error or (invocation.error if invocation is not None
                           else "unknown error")
        super().__init__(
            f"workflow {workflow!r} failed at step {step!r} "
            f"after {attempts} attempt(s): {detail}")
        self.workflow = workflow
        self.step = step
        self.attempts = attempts
        self.invocation = invocation


class Step:
    """One node of a workflow DAG: a runtime invocation plus its inputs.

    Created through :meth:`Workflow.step` / :meth:`Workflow.fan_out` — not
    directly.  Exactly one input source: a literal ``payload`` (staged to
    the object store at launch), an already-staged ``data_ref``, or the
    outputs of ``after`` dependencies (chain for one parent, fan-in list
    for several).
    """

    def __init__(self, name: str, runtime_id: str, *,
                 payload: Any = None, data_ref: Optional[str] = None,
                 deps: Sequence["Step"] = (),
                 config: Optional[Dict[str, Any]] = None, retries: int = 0):
        self.name = name
        self.runtime_id = runtime_id
        self.payload = payload
        self.data_ref = data_ref
        self.deps: List[Step] = list(deps)
        self.config = dict(config or {})
        self.retries = max(int(retries), 0)

    def __repr__(self) -> str:
        deps = [d.name for d in self.deps]
        return f"Step({self.name!r}, {self.runtime_id!r}, deps={deps})"


class Workflow:
    """Builder for a DAG of runtime invocations (the composition DSL).

    Chains, fan-out and fan-in are all expressed through ``after``:

    * chain    — ``wf.step("b", rid, after=a)`` (b's data = a's output)
    * fan-out  — ``wf.fan_out("tile", rid, payloads=[...])`` (one step per
      payload, named ``tile[0]``, ``tile[1]``, ...)
    * fan-in   — ``wf.step("join", rid, after=[s1, s2, ...])`` (a gather
      barrier: data = the list of parent outputs, in declared order)

    Acyclic by construction: ``after`` may only reference steps already
    declared on this workflow.
    """

    def __init__(self, name: str):
        self.name = name
        self.steps: "Dict[str, Step]" = {}      # insertion-ordered

    # -- construction ---------------------------------------------------
    def step(self, name: str, runtime_id: str, *, payload: Any = None,
             data_ref: Optional[str] = None,
             after: Union[None, Step, Sequence[Step]] = None,
             config: Optional[Dict[str, Any]] = None,
             retries: int = 0) -> Step:
        """Declare one step; returns it for use in later ``after=``.

        ``after`` is a Step (chain) or a list of Steps (fan-in barrier).
        ``payload``/``data_ref`` are mutually exclusive with ``after`` and
        with each other; a source step may also take no input at all.
        ``retries`` resubmits the step on failure (including admission
        rejections) before the failure propagates.
        """
        deps = [after] if isinstance(after, Step) else list(after or ())
        if name in self.steps:
            raise ValueError(f"duplicate step name {name!r} "
                             f"in workflow {self.name!r}")
        if sum(x is not None for x in (payload, data_ref, after or None)) > 1:
            raise ValueError(f"step {name!r}: pass at most one of "
                             f"payload / data_ref / after")
        for d in deps:
            if self.steps.get(d.name) is not d:
                raise ValueError(
                    f"step {name!r} depends on {d.name!r}, which is not a "
                    f"step of workflow {self.name!r} (declare it first)")
        s = Step(name, runtime_id, payload=payload, data_ref=data_ref,
                 deps=deps, config=config, retries=retries)
        self.steps[name] = s
        return s

    def fan_out(self, name: str, runtime_id: str, payloads: Sequence[Any],
                *, config: Optional[Dict[str, Any]] = None,
                retries: int = 0) -> List[Step]:
        """Declare one step per payload (``name[i]``) — the map stage.

        Returns the steps in payload order; pass the list to a later
        ``step(after=...)`` to close the fan with a gather barrier.
        """
        return [self.step(f"{name}[{i}]", runtime_id, payload=p,
                          config=config, retries=retries)
                for i, p in enumerate(payloads)]

    # -- shape ----------------------------------------------------------
    def sinks(self) -> List[Step]:
        """Steps nothing depends on — the workflow's outputs."""
        has_child = {d.name for s in self.steps.values() for d in s.deps}
        return [s for s in self.steps.values() if s.name not in has_child]

    def validate(self) -> None:
        """Raise ValueError on an unsubmittable workflow (e.g. empty)."""
        if not self.steps:
            raise ValueError(f"workflow {self.name!r} has no steps")


class _StepState:
    """Runner-side mutable state for one step."""

    __slots__ = ("step", "status", "attempts", "future", "data_ref",
                 "result_ref", "error")

    def __init__(self, step: Step):
        self.step = step
        self.status = PENDING
        self.attempts = 0
        self.future: Optional[InvocationFuture] = None   # last attempt
        self.data_ref: Optional[str] = None              # resolved input
        self.result_ref: Optional[str] = None            # settled output ref
        #   (from the step's invocation, or the resume index for steps
        #    restored from a previous submission's persisted outcome)
        self.error: Optional[str] = None


class _WorkflowState:
    """Runner-side state for one submitted workflow."""

    def __init__(self, wf: Workflow, resume_key: Optional[str] = None):
        self.wf = wf
        # crash recovery: when set, each finished step's outcome is
        # aliased under the deterministic key ``wfres:<resume_key>:<step>``
        # and a re-submission restores those steps as DONE instead of
        # recomputing them
        self.resume_key = resume_key
        # unique per submission: two workflows may share a name, but their
        # staged fan-in objects must not collide in the store
        self.uid = next(_submission_ids)
        self.steps = {name: _StepState(s) for name, s in wf.steps.items()}
        self.children: Dict[str, List[str]] = {n: [] for n in wf.steps}
        for s in wf.steps.values():
            for d in s.deps:
                self.children[d.name].append(s.name)
        self.finished = threading.Event()
        self.error: Optional[WorkflowStepError] = None

    @property
    def live(self) -> bool:
        return not self.finished.is_set()


class WorkflowFuture:
    """Async handle for one submitted workflow (mirrors InvocationFuture).

    ``result()`` blocks until the whole DAG settles, then returns the sink
    step's output (a ``{name: output}`` dict when there are several sinks)
    — or raises :class:`WorkflowStepError` for the step that failed.
    """

    def __init__(self, state: _WorkflowState, runner: "WorkflowRunner"):
        self._state = state
        self._runner = runner

    @property
    def name(self) -> str:
        """The workflow's name."""
        return self._state.wf.name

    def done(self) -> bool:
        """True once every step is done / failed / cancelled."""
        return self._state.finished.is_set()

    def statuses(self) -> Dict[str, str]:
        """Step name -> pending/running/done/failed/cancelled snapshot."""
        return {n: ss.status for n, ss in self._state.steps.items()}

    def step_future(self, name: str) -> Optional[InvocationFuture]:
        """The last invocation future of step ``name`` (None while pending
        or when the step was cancelled before submission)."""
        return self._state.steps[name].future

    def locality_hits(self) -> int:
        """Steps whose invocation read its input from a node-local copy
        (placement co-located the child with the node holding its
        parent's result — no store round-trip).  Final after ``done()``."""
        return sum(1 for ss in self._state.steps.values()
                   if ss.future is not None
                   and ss.future.invocation.locality_hit)

    def locality_rate(self) -> float:
        """Locality hits over locality-*eligible* steps — single-parent
        chain steps (fan-in gathers stage a fresh combined object that is
        resident nowhere).  1.0 when no step is eligible."""
        eligible = [ss for ss in self._state.steps.values()
                    if len(ss.step.deps) == 1]
        if not eligible:
            return 1.0
        hits = sum(1 for ss in eligible if ss.future is not None
                   and ss.future.invocation.locality_hit)
        return hits / len(eligible)

    def result(self, *, extra_time_s: float = 600.0) -> Any:
        """Block until the workflow settles; return the sink output(s).

        Raises :class:`WorkflowStepError` (naming the failing step) when
        any step exhausted its retries.  ``extra_time_s`` bounds each
        *wait for progress* — wall seconds for the whole DAG on an
        autonomous (engine) backend, virtual seconds per settlement on
        the sim (a deep chain may legitimately advance several bounds'
        worth of virtual time) — and ``TimeoutError`` is raised when the
        backend cannot settle anything within one bound.
        """
        self._runner.wait(self._state, extra_time_s=extra_time_s)
        if self._state.error is not None:
            raise self._state.error
        outs = {s.name: self._runner.step_output(self._state, s.name)
                for s in self._state.wf.sinks()}
        return next(iter(outs.values())) if len(outs) == 1 else outs


class WorkflowRunner:
    """Drives workflow DAGs over one gateway.

    Submits each step the moment its dependencies resolve.  On an
    autonomous backend (engine) every workflow gets a daemon driver thread
    reacting to settlements; on the sim backend progress happens inside
    ``WorkflowFuture.result()`` / :meth:`wait`, which advance the virtual
    clock step-by-step and drive *all* live workflows together so their
    steps interleave in virtual time exactly as they would in wall time.
    """

    def __init__(self, gateway):
        self.gateway = gateway
        self._lock = threading.RLock()
        self._live: List[_WorkflowState] = []

    # -- submission ------------------------------------------------------
    def submit(self, wf: Workflow, *, resume: bool = False
               ) -> WorkflowFuture:
        """Validate ``wf``, launch its source steps, return its future.

        With ``resume=True``, steps whose results a previous submission
        of this workflow (same name) already persisted in the object
        store are restored as DONE without resubmission — a crashed
        driver or a failed-and-fixed step re-runs only the unfinished
        suffix of the DAG, never its finished parents.
        """
        wf.validate()
        state = _WorkflowState(wf, resume_key=wf.name if resume else None)
        with self._lock:
            self._live.append(state)
            if state.resume_key is not None:
                self._restore_resumed(state)
            self._advance(state)    # launch sources (and finalize if they
            #                         all failed to even submit)
        if self.gateway.backend.autonomous and not state.finished.is_set():
            threading.Thread(target=self._drive, args=(state,),
                             name=f"wf-{wf.name}", daemon=True).start()
        return WorkflowFuture(state, self)

    def _resume_ref(self, state: _WorkflowState, step_name: str) -> str:
        return f"wfres:{state.resume_key}:{step_name}"

    def _restore_resumed(self, state: _WorkflowState) -> None:
        """Mark steps DONE whose successful outcome is already persisted
        under this workflow's deterministic resume keys."""
        store = self.gateway.backend.store
        for name, ss in state.steps.items():
            ref = self._resume_ref(state, name)
            if ref not in store:
                continue
            rec = store.get(ref)
            if is_outcome(rec) and rec["ok"]:
                ss.status = DONE
                ss.result_ref = ref

    def step_output(self, state: _WorkflowState, name: str) -> Any:
        """A DONE step's output value (via its future, or straight from
        the store for steps restored by resume)."""
        ss = state.steps[name]
        if ss.future is not None:
            return ss.future.result()
        return unwrap_outcome(
            self.gateway.backend.store.get(ss.result_ref))

    # -- waiting ---------------------------------------------------------
    def wait(self, state: _WorkflowState, *,
             extra_time_s: float = 600.0) -> None:
        """Block until ``state`` finishes (driving it if pull-mode)."""
        if self.gateway.backend.autonomous:
            if not state.finished.wait(timeout=extra_time_s):
                raise TimeoutError(
                    f"workflow {state.wf.name!r} did not settle within "
                    f"+{extra_time_s}s (statuses: "
                    f"{ {n: s.status for n, s in state.steps.items()} })")
            return
        while state.live:
            progressed = self._pump(extra_time_s)
            if not progressed and state.live:
                stuck = [n for n, s in state.steps.items()
                         if s.status in (PENDING, RUNNING)]
                raise TimeoutError(
                    f"workflow {state.wf.name!r} stalled: steps {stuck} "
                    f"cannot settle within +{extra_time_s}s of virtual "
                    f"time (is the runtime supported by any node?)")

    def _pump(self, extra_time_s: float) -> bool:
        """Pull-mode drive: advance the backend until some in-flight step
        of ANY live workflow settles, then settle/launch across all of
        them.  Returns False when the backend could not progress."""
        with self._lock:
            inflight = [ss.future.invocation
                        for st in self._live for ss in st.steps.values()
                        if ss.status == RUNNING and ss.future is not None]
        if not inflight:
            # nothing in flight anywhere: either all finished, or a bug —
            # report no progress so wait() can surface the stall
            return False
        ok = self.gateway.backend.wait_any(inflight, timeout_s=extra_time_s)
        if ok:
            with self._lock:
                for st in list(self._live):
                    self._advance(st)
        return ok

    def _drive(self, state: _WorkflowState) -> None:
        """Autonomous-mode driver thread: one workflow, react on settle."""
        try:
            while state.live:
                with self._lock:
                    inflight = [ss.future.invocation
                                for ss in state.steps.values()
                                if ss.status == RUNNING
                                and ss.future is not None]
                if not inflight:
                    with self._lock:
                        self._advance(state)
                        if state.live:   # live with nothing in flight: bug
                            state.error = WorkflowStepError(
                                state.wf.name, "<runner>", 0,
                                error="runner stalled with no steps in "
                                      "flight")
                            self._finalize(state)
                    break
                self.gateway.backend.wait_any(inflight, timeout_s=5.0)
                with self._lock:
                    self._advance(state)
        except Exception as e:  # noqa: BLE001 — never leave waiters hanging
            with self._lock:
                if state.live:
                    state.error = WorkflowStepError(
                        state.wf.name, "<runner>", 0,
                        error=f"workflow runner crashed: {e!r}")
                    self._finalize(state)

    # -- DAG engine (all called under self._lock) ------------------------
    def _advance(self, state: _WorkflowState) -> None:
        """Settle finished invocations, retry/propagate, launch unblocked
        steps, and finalize when no step remains live."""
        if not state.live:
            return
        for ss in state.steps.values():
            if ss.status != RUNNING or ss.future is None \
                    or not ss.future.done():
                continue
            inv = ss.future.invocation
            if inv.success:
                ss.status = DONE
                ss.result_ref = inv.result_ref
                if state.resume_key is not None and \
                        inv.result_ref is not None:
                    # index the outcome under the deterministic resume key
                    # so a re-submission can skip this step (no copy)
                    self.gateway.backend.store.alias(
                        inv.result_ref,
                        self._resume_ref(state, ss.step.name))
            elif ss.attempts <= ss.step.retries:
                self._launch(state, ss)          # retry: resubmit as-is
            else:
                ss.status = FAILED
                ss.error = inv.error
                self._cancel_downstream(state, ss.step.name)
        self._launch_ready(state)
        if all(ss.status in (DONE, FAILED, CANCELLED)
               for ss in state.steps.values()):
            failed = [ss for ss in state.steps.values()
                      if ss.status == FAILED]
            if failed:
                ss = failed[0]
                state.error = WorkflowStepError(
                    state.wf.name, ss.step.name, ss.attempts,
                    invocation=ss.future.invocation if ss.future else None,
                    error=ss.error)
            self._finalize(state)

    def _launch_ready(self, state: _WorkflowState) -> None:
        for ss in state.steps.values():
            if ss.status == PENDING and all(
                    state.steps[d.name].status == DONE
                    for d in ss.step.deps):
                self._launch(state, ss)

    def _launch(self, state: _WorkflowState, ss: _StepState) -> None:
        """Resolve the step's input to an object-store ref and submit it."""
        step = ss.step
        try:
            if ss.data_ref is None:          # first attempt: stage input
                ss.data_ref = self._resolve_input(state, step)
            # a dependent step's RStart is the instant its last input
            # landed in the object store (the parent's NEnd) — on the sim
            # those timestamps sit slightly ahead of the completion
            # callback (modeled upload latency), so pin the event there to
            # keep the virtual-time dependency chain exact.  Parents
            # restored by resume have no invocation this submission;
            # their output already exists, so they do not pin time.
            at = None
            if step.deps:
                ends = [state.steps[d.name].future.invocation.n_end
                        if state.steps[d.name].future is not None else None
                        for d in step.deps]
                if all(e is not None for e in ends):
                    at = max(max(ends), self.gateway.backend.now())
            ss.attempts += 1
            ss.future = self.gateway.invoke(
                step.runtime_id, data_ref=ss.data_ref or None,
                config=step.config, at=at,
                workflow=state.wf.name, step=step.name)
            ss.status = RUNNING
        except Exception as e:  # noqa: BLE001 — a bad step must not wedge
            ss.status = FAILED
            ss.error = f"submit failed: {e!r}"
            self._cancel_downstream(state, step.name)

    def _resolve_input(self, state: _WorkflowState, step: Step) -> str:
        """The object-store data plane between steps.

        chain:  the child's data_ref IS the parent's result_ref (zero
        client copies); fan-in: one combined list staged via
        ``ObjectStore.gather``; source: stage the literal payload.
        """
        store = self.gateway.backend.store
        if step.deps:
            refs = [state.steps[d.name].result_ref for d in step.deps]
            if any(r is None for r in refs):
                raise RuntimeError(f"step {step.name!r}: a dependency "
                                   f"settled without a result ref")
            if len(refs) == 1:
                return refs[0]
            return store.gather(
                refs,
                key=f"workflow:{state.wf.name}#{state.uid}:{step.name}:in")
        if step.data_ref is not None:
            return step.data_ref
        if step.payload is not None:
            return store.put(step.payload)
        return ""

    def _cancel_downstream(self, state: _WorkflowState, name: str) -> None:
        """Poison every transitive descendant of a failed step — they are
        never submitted, so nothing orphans in the backend queues."""
        for child in state.children[name]:
            css = state.steps[child]
            if css.status in (PENDING, RUNNING):
                # RUNNING children are impossible (deps gate submission);
                # guard anyway so a future refactor cannot orphan them
                css.status = CANCELLED
                css.error = f"upstream step {name!r} failed"
                self._cancel_downstream(state, child)

    def _finalize(self, state: _WorkflowState) -> None:
        if state in self._live:
            self._live.remove(state)
        state.finished.set()
