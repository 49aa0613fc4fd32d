"""Transparent in-flight request migration.

A copy of ``dynamo_tpu/resilience/migration.py`` without its tracing
events: the same resume annotation and avoid list, so either package's
frontend resumes either package's streams.

:class:`MigratingEngine` wraps the frontend's dispatch stage (normally
the KV-routed client engine) at the PreprocessedRequest ->
LLMEngineOutput level — *below* the detokenizer, so the incremental
decode / stop-jail state upstream never notices a seam — and makes
worker death invisible to clients:

  * **checkpoint**: every token id that reaches the client is recorded
    per in-flight request (the only state migration needs — the KV is
    recomputable, the tokens are not);
  * **classify**: a stream failure is classified (resilience/policy.py)
    as worker-lost (lease gone), transient (control-plane blip), or
    fatal (deterministic engine error);
  * **re-dispatch**: retryable failures re-enter the wrapped engine as
    ``prompt + tokens-so-far`` with a ``resume`` annotation carrying the
    original prompt length. The engine (engine/engine.py) restores the
    prompt/generated split from it, so

      - sampling continues the *same* RNG stream (per-step keys are
        ``fold_in(seed, generated)`` — generated resumes at the seam),
      - frequency/presence/repetition penalty state rebuilds from the
        true prompt/output split (not the spliced prompt),
      - ``max_tokens``/``min_tokens``/usage accounting count from the
        original prompt,

    which makes the splice exactly-once and, for greedy decoding,
    bit-exact against an undisturbed run (the engine's preemption
    replay path gives the same guarantee intra-worker);
  * **KV-aware placement**: the resumed request flows through the same
    KV router, whose radix index scores the (prompt + generated) chain
    against every surviving worker — the replacement lands where the
    longest prefix already sits, and the router's ``kv-prefetch`` hint
    starts warming the host tier before the request arrives.

The wrapper never retries a failure another worker cannot absorb: see
policy.classify_failure. ``max_migrations`` and ``deadline_s`` bound the
worst case; ``enabled=False`` restores the old die-with-the-worker
behavior.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Optional

from ..protocols.common import PreprocessedRequest
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from .policy import (
    WORKER_LOST_SIGNATURES,
    FailureKind,
    MigrationPolicy,
    classify_failure,
)

logger = logging.getLogger(__name__)

#: request.annotations key the KV router stamps with its pinned worker id
#: (lets the classifier distinguish lease loss from a TCP blip)
ROUTED_WORKER_KEY = "routed_worker_id"

#: request.annotations key listing the worker ids this request already
#: failed on — the KV router soft-excludes them when re-scheduling, so a
#: killed worker whose lease has not yet expired (and whose radix prefix
#: affinity would otherwise win every re-pick) doesn't eat the migration
#: budget before discovery notices the death
AVOID_WORKER_KEY = "migration.avoid_workers"

#: PreprocessedRequest.annotations key carrying the resume state the
#: engine restores the prompt/generated split from
RESUME_KEY = "resume"


def _inspect_chunk(data) -> tuple[list[int], Optional[str], Optional[str]]:
    """-> (token_ids, finish_reason_value_or_None, text) for a stream
    chunk in either wire (dict) or in-process (LLMEngineOutput) shape."""
    if isinstance(data, dict):
        return (
            list(data.get("token_ids") or []),
            data.get("finish_reason"),
            data.get("text"),
        )
    fr = getattr(data, "finish_reason", None)
    if fr is not None:
        fr = getattr(fr, "value", fr)
    return (
        list(getattr(data, "token_ids", None) or []),
        fr,
        getattr(data, "text", None),
    )


def _is_handoff_text(text: Optional[str]) -> bool:
    return bool(text) and any(sig in text for sig in WORKER_LOST_SIGNATURES)


class MigratingEngine(AsyncEngine):
    """Migration-aware stream wrapper (see module doc).

    ``client`` (optional) is the discovery Client whose store watch
    tracks live instances — used only to refine worker-lost vs. TCP-blip
    classification; the wrapper works without it.
    """

    def __init__(
        self,
        inner: AsyncEngine,
        policy: Optional[MigrationPolicy] = None,
        client=None,
    ):
        self.inner = inner
        self.policy = policy or MigrationPolicy()
        self.client = client
        self.stats = {
            # successful + attempted re-dispatches (one per seam)
            "migrations_total": 0,
            # distinct requests that hit at least one retryable failure
            "requests_migrated": 0,
            # requests whose failure was surfaced (fatal / budget spent)
            "migration_failures": 0,
        }

    async def close(self) -> None:
        await self.inner.close()

    async def generate(self, request: Context) -> AsyncIterator:
        data = request.data
        if isinstance(data, PreprocessedRequest):
            base = data.to_dict()
        elif isinstance(data, dict) and "token_ids" in data:
            base = dict(data)
        else:
            # not a token-level request (text engines, custom payloads):
            # nothing to splice — pass straight through
            async for item in self.inner.generate(request):
                yield item
            return

        base_tokens = list(base.get("token_ids") or [])
        base_ann = dict(base.get("annotations") or {})
        # an already-resumed request (e.g. re-entering through a second
        # frontend) keeps its ORIGINAL prompt length
        prompt_len = len(base_tokens)
        prior = base_ann.get(RESUME_KEY) or {}
        if isinstance(prior, dict) and prior.get("prompt_len"):
            try:
                prompt_len = min(int(prior["prompt_len"]), prompt_len)
            except (TypeError, ValueError):
                pass

        emitted: list[int] = []  # every token id the client has seen
        avoid: set[int] = set()  # workers this request already failed on
        attempts = 0
        deadline: Optional[float] = None
        cur = request
        loop = asyncio.get_running_loop()

        while True:
            failure: Optional[str] = None
            exc: Optional[BaseException] = None
            try:
                async for item in self.inner.generate(cur):
                    a = (
                        item
                        if isinstance(item, Annotated)
                        else Annotated.from_data(item)
                    )
                    if a.is_error():
                        failure = a.error or "engine error"
                        break
                    if a.data is None:
                        yield item
                        continue
                    toks, fr, text = _inspect_chunk(a.data)
                    if fr == "error" and _is_handoff_text(text):
                        # a draining/dead worker terminated the stream
                        # with the migration signal — never client-visible
                        failure = text
                        break
                    emitted.extend(toks)
                    yield item
                    if fr is not None:
                        return  # clean terminal chunk: done
            except Exception as e:  # noqa: BLE001 — dispatch failures
                # (NoResponders, hub ConnectionError, connect timeouts)
                # and in-process FaultInjected kills land here
                exc = e
                failure = f"{type(e).__name__}: {e}"
            if failure is None and exc is None:
                # the stream ended with neither a finish chunk nor an
                # error: a silent truncation (in-process analogue of the
                # TCP sentinel-less EOF) — retryable
                failure = (
                    "response stream truncated: stream ended without a "
                    "finish chunk"
                )

            ctx_ann = cur.annotations if isinstance(cur.annotations, dict) else {}
            kind = classify_failure(
                failure,
                exc,
                worker_id=ctx_ann.get(ROUTED_WORKER_KEY),
                client=self.client,
            )
            if kind.retryable and isinstance(
                ctx_ann.get(ROUTED_WORKER_KEY), int
            ):
                # steer the re-dispatch away from the worker that just
                # failed — even a "transient" verdict may be a corpse
                # whose lease hasn't expired yet (soft exclusion: the
                # router falls back to it if nothing else is alive)
                avoid.add(ctx_ann[ROUTED_WORKER_KEY])
            if (
                not self.policy.enabled
                or not kind.retryable
                or request.context.is_killed()
            ):
                if self.policy.enabled and kind.retryable:
                    # killed mid-migration: the client is gone; end quietly
                    return
                self.stats["migration_failures"] += 1
                yield Annotated.from_error(failure)
                return

            now = loop.time()
            if deadline is None:
                deadline = now + self.policy.deadline_s
            attempts += 1
            if attempts > self.policy.max_migrations or now >= deadline:
                self.stats["migration_failures"] += 1
                logger.warning(
                    "request %s: migration budget exhausted after %d "
                    "re-dispatches (%s)", request.id, attempts - 1, failure,
                )
                yield Annotated.from_error(
                    f"migration budget exhausted after {attempts - 1} "
                    f"re-dispatches: {failure}"
                )
                return

            if attempts == 1:
                self.stats["requests_migrated"] += 1
            self.stats["migrations_total"] += 1
            logger.info(
                "request %s: %s (%s); re-dispatching with %d tokens so far "
                "(attempt %d/%d)", request.id, kind.value, failure,
                len(emitted), attempts, self.policy.max_migrations,
            )
            if kind is FailureKind.TRANSIENT:
                # deterministic ordinal backoff: the control plane needs
                # a beat to heal (hub redial, membership settling)
                await asyncio.sleep(self.policy.backoff_s * attempts)
            elif attempts > 1:
                # repeated worker-lost bounces (rolling drain with no
                # survivor up yet) pace the same way — only the FIRST
                # re-dispatch is instant, so the attempt budget can't
                # burn out in microseconds while deadline_s has room
                await asyncio.sleep(self.policy.backoff_s * attempts)
            cur = self._resume_request(
                request, base, base_ann, base_tokens, emitted, prompt_len,
                attempts, avoid,
            )

    @staticmethod
    def _resume_request(
        request: Context,
        base: dict,
        base_ann: dict,
        base_tokens: list[int],
        emitted: list[int],
        prompt_len: int,
        attempts: int,
        avoid: set,
    ) -> Context:
        """Build the re-dispatch: prompt + tokens-so-far, with the resume
        annotation restoring the original prompt/generated split."""
        payload = dict(base)
        payload["token_ids"] = base_tokens + emitted
        ann = dict(base_ann)
        ann[RESUME_KEY] = {"prompt_len": prompt_len, "migrations": attempts}
        payload["annotations"] = ann
        ctx_ann = dict(request.annotations or {})
        ctx_ann.pop(ROUTED_WORKER_KEY, None)
        if avoid:
            ctx_ann[AVOID_WORKER_KEY] = sorted(avoid)
        # same AsyncEngineContext: request identity and stop/kill
        # propagation survive the seam
        return Context(payload, request.context, ctx_ann)
