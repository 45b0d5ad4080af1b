"""Supervisor decision policy: debounced events → one action (a copy of
``stochastic_gradient_push_tpu/supervise/policy.py``).

The raw inputs are noisy: the recovery policy emits a re-plan
suggestion on *every* firing (resilience/recovery.py), a single
straggler step can trip the watchdog once, and a child exit code can
mean "done", "requeue me", or "a rank died".  This module turns them
into at most one relaunch cycle per cause:

* **re-plan suggestions** must be *sustained*: at least
  ``replan_count`` consecutive ``suggestion.switch == true`` recovery
  events spanning at least ``replan_cooldown_steps`` training steps.
  One transient suggestion — or a flapping one (a ``switch: false``
  event resets the streak) — triggers nothing.  After a relaunch the
  streak starts empty, so the *same* backlog of suggestions can never
  fire twice.
* **stalls** (watchdog ``heartbeat`` events with error severity, or the
  supervisor's own event-staleness timer) mean a rank is gone or
  unreachable: the child cannot drain gracefully (its main thread is
  inside the dead collective), so the action is a hard restart with a
  world shrink.
* **child exits** map by code: 0 = run complete;
  ``REQUEUE_EXIT_CODE`` = the child checkpointed and wants a requeue
  (relaunch at the same world); anything else = crash/kill = rank loss
  (shrink), bounded by ``max_restarts``.

Two long-run disciplines temper the budget:

* **backoff** — consecutive *failure* relaunches (crash/stall, not a
  healthy drain) back off exponentially with deterministic jitter
  (:meth:`SupervisorPolicy.next_backoff_s`): a crash loop costs
  ``base·2ᵏ`` seconds per attempt instead of hammering the scheduler,
  and the jitter keeps a pod's supervisors from relaunching in
  lockstep.  Deterministic (a hash of the generation and the
  supervisor's ``jitter_salt`` identity — fleet mode salts with the
  host id), so tests pin exact values and a resumed supervisor
  reproduces the same pacing;
* **budget refill** — after ``refill_steps`` of observed training
  progress since the last relaunch, the restart budget refills and the
  backoff streak resets: a week-long run that hits a transient crash
  loop on Monday still has its full budget on Friday.  Without this,
  ``max_restarts`` is a lifetime cap and any long-enough run
  eventually dies of old incidents.

The class is pure host state — no subprocess, no filesystem — so the
debounce/cooldown/backoff/refill contract is pinned by plain unit
tests (tests/test_torch_supervise.py holds them to the reference's).
"""

from __future__ import annotations

import dataclasses

from ..utils.checkpoint import REQUEUE_EXIT_CODE

__all__ = ["Action", "SupervisorPolicy"]


@dataclasses.dataclass(frozen=True)
class Action:
    """One supervisor decision.

    ``kind``:
      * ``"drain-restart"`` — child is healthy: SIGUSR1 checkpoint
        drain, then reshard/replan/relaunch (same world);
      * ``"restart"`` — child is dead or wedged: kill if needed, then
        reshard to the shrunken world and relaunch;
      * ``"relaunch"`` — child checkpointed and exited with the requeue
        code on its own; respawn at the same world;
      * ``"complete"`` / ``"give-up"`` — terminal.
    """

    kind: str
    reason: str = ""
    shrink: bool = False


class SupervisorPolicy:
    def __init__(self, world: int, replan_count: int = 3,
                 replan_cooldown_steps: int = 20,
                 stall_count: int = 1,
                 max_restarts: int = 3,
                 shrink_factor: int = 2,
                 min_world: int = 1,
                 backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 backoff_jitter: float = 0.25,
                 jitter_salt: int = 0,
                 refill_steps: int = 200):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.replan_count = max(1, replan_count)
        self.replan_cooldown_steps = max(0, replan_cooldown_steps)
        self.stall_count = max(1, stall_count)
        self.max_restarts = max_restarts
        self.shrink_factor = max(1, shrink_factor)
        self.min_world = max(1, min_world)
        # relaunch pacing: failure k sleeps backoff_base_s * 2^(k-1)
        # scaled by a deterministic jitter in [1, 1+backoff_jitter),
        # capped at backoff_max_s; 0 base disables backoff entirely
        self.backoff_base_s = max(0.0, backoff_base_s)
        self.backoff_max_s = max(0.0, backoff_max_s)
        self.backoff_jitter = max(0.0, backoff_jitter)
        # identity salt for the jitter hash: a pod-wide transient
        # crashes every host at the SAME generation, so without a
        # per-host salt every supervisor would compute an identical
        # backoff and relaunch in lockstep (fleet mode passes the host
        # id; still fully deterministic for a given identity)
        self.jitter_salt = int(jitter_salt)
        # restart-budget refill: this many observed training steps of
        # progress since the last relaunch restore the full budget and
        # clear the failure streak (0 = never refill — the old
        # hard-lifetime-cap behavior)
        self.refill_steps = max(0, refill_steps)
        self.restarts = 0
        self.generation = 0
        self.consecutive_failures = 0
        self._switch_steps: list[int] = []
        self._stalls = 0
        self._progress_base: int | None = None

    # -- event stream ------------------------------------------------------

    def observe(self, event: dict) -> Action | None:
        """Digest one typed event from the child's stream; returns an
        action when one is due, else None.  Unknown kinds are ignored
        (the registry vocabulary may be newer than this supervisor)."""
        kind = event.get("kind")
        data = event.get("data") or {}
        self._observe_progress(event, data)
        if kind == "recovery":
            suggestion = data.get("suggestion") or {}
            if "switch" not in suggestion:
                return None
            if not suggestion["switch"]:
                # the planner stopped suggesting a different topology:
                # the streak was noise, not a sustained signal
                self._switch_steps.clear()
                return None
            step = data.get("step", event.get("step", 0))
            self._switch_steps.append(int(step))
            span = self._switch_steps[-1] - self._switch_steps[0]
            if (len(self._switch_steps) >= self.replan_count
                    and span >= self.replan_cooldown_steps):
                if not self._budget_left():
                    return self._give_up("re-plan suggestion sustained")
                return Action("drain-restart",
                              reason="replan-suggestion "
                                     f"({len(self._switch_steps)} events "
                                     f"over {span} steps)")
            return None
        if kind == "heartbeat" and event.get("severity") == "error":
            self._stalls += 1
            if self._stalls >= self.stall_count:
                return self._rank_loss(
                    f"stalled-rank ({self._stalls} watchdog stall(s))")
            return None
        return None

    def on_stale(self, silent_s: float) -> Action:
        """No events for ``silent_s`` seconds while the child process is
        still alive — the heartbeat went quiet (hung collective)."""
        return self._rank_loss(f"heartbeat-loss (no events for "
                               f"{silent_s:.0f}s)")

    def on_child_exit(self, code: int) -> Action:
        if code == 0:
            return Action("complete", reason="child exited cleanly")
        if code == REQUEUE_EXIT_CODE:
            if not self._budget_left():
                return self._give_up("child requested requeue")
            return Action("relaunch", reason="child-requeue "
                          f"(exit {REQUEUE_EXIT_CODE} after checkpoint)")
        return self._rank_loss(f"child-exit (code {code})")

    # -- progress / refill -------------------------------------------------

    def _observe_progress(self, event: dict, data: dict) -> None:
        """A sustained healthy-progress window refills the restart
        budget and clears the failure streak: `refill_steps` training
        steps observed since the last relaunch prove the run is back on
        its feet, so old incidents stop counting against it."""
        if self.refill_steps <= 0:
            return
        # data-first, envelope fallback — the same convention the
        # recovery-suggestion debounce uses
        step = data.get("step", event.get("step"))
        if step is None:
            return
        step = int(step)
        if self._progress_base is None or step < self._progress_base:
            # first sighting this generation (or a resumed counter that
            # restarted lower): baseline, don't credit the jump
            self._progress_base = step
            return
        if (step - self._progress_base >= self.refill_steps
                and (self.restarts or self.consecutive_failures)):
            self.restarts = 0
            self.consecutive_failures = 0
            self._progress_base = step

    def next_backoff_s(self) -> float:
        """Seconds to wait before the next relaunch: 0 after a healthy
        drain, exponential in the consecutive-failure streak otherwise.
        The jitter factor is a hash of (generation, jitter_salt) —
        deterministic (tests pin it, a resumed supervisor repaces
        identically) yet de-synchronized across generations AND across
        hosts that crashed at the same generation."""
        k = self.consecutive_failures
        if k <= 0 or self.backoff_base_s <= 0:
            return 0.0
        raw = self.backoff_base_s * (2.0 ** (k - 1))
        frac = (((self.generation + 1) * 2654435761
                 + self.jitter_salt * 2246822519) % (2 ** 32)) / (2 ** 32)
        return min(self.backoff_max_s,
                   raw * (1.0 + self.backoff_jitter * frac))

    # -- transitions -------------------------------------------------------

    def _budget_left(self) -> bool:
        return self.max_restarts <= 0 or self.restarts < self.max_restarts

    def _give_up(self, cause: str) -> Action:
        return Action("give-up", reason=f"{cause}, but restart budget "
                      f"({self.max_restarts}) is spent")

    def _rank_loss(self, reason: str) -> Action:
        if not self._budget_left():
            return self._give_up(reason)
        return Action("restart", reason=reason, shrink=True)

    def target_world(self, shrink: bool) -> int:
        """World size for the next generation."""
        if not shrink:
            return self.world
        return max(self.min_world, self.world // self.shrink_factor)

    def mark_relaunched(self, new_world: int,
                        failure: bool = False) -> None:
        """A relaunch cycle completed: advance the generation and clear
        the debounce state, so pre-restart evidence cannot trigger a
        second cycle.  ``failure`` extends the consecutive-failure
        streak (crash/stall relaunches back off; healthy drains —
        requeue, sustained replan — relaunch immediately)."""
        self.world = new_world
        self.generation += 1
        self.restarts += 1
        self.consecutive_failures = (self.consecutive_failures + 1
                                     if failure else 0)
        self._switch_steps.clear()
        self._stalls = 0
        self._progress_base = None
