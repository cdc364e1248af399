"""Disaggregated prefill/decode LLM serving (docs/disaggregation.md).

Generation is split into the two stages of the ``llm_disagg`` workflow:

  * **prefill** — ``ServingEngine.prefill`` over the prompt (batched under
    the coalescer when the instance runs ``max_batch > 1``).  Each request's
    KV cache leaves are sliced out along their batch axes
    (``engine.batch_axes``), copied to the host, and shipped downstream as
    one :class:`~repro_torch.core.messaging.KVPages` — one gather list, one
    ``RdmaFabric.writev``.

  * **decode** — a :class:`ContinuousDecoder`, a continuous stage: requests
    join and leave a running slot batch at segment boundaries.  The
    instance scheduler pumps ``tick()`` between inbox polls; finished
    requests are delivered under their original message identity, and
    in-flight prefixes stream through the database as ``partial/<uid>``.

Pages are numpy arrays, and numpy has no bfloat16: a bfloat16 leaf travels
as its 16-bit integer view, its dtype listed in ``meta["page_dtypes"]``,
and is viewed back on the decode side bit for bit (``to_page`` /
``from_page``).  Raw ``bytes`` never ride in a payload: the messaging
layer's generic encoder refuses them.

A whole padded cache is one message: at qwen3-1.7b's widths and ``max_len``
1024 it is 28 x 2 x 8 x 1024 x 128 x 2 B = 117.4 MB, over 7x the 16 MiB
inbox ring the JAX package defaults to, and a message that does not fit a
ring is dropped (§9).  rwkv6-7b's message is its recurrent state, the same
34.08 MB at any prompt length (two bfloat16 token-shift leaves of 0.26 MB
and the float32 WKV state, 32 x 64 x 64 x 64 x 4 B = 33.55 MB).
``build_llm_disagg_set`` therefore sizes each inbox from the shapes
(``ring_bytes_for``).  The decode instance takes one inbox entry per
segment it decodes (its scheduler ticks the slot batch, then polls once),
so a burst of prefilled requests waits in the ring (internvl2-1b
prefills its 13.2 MB messages faster than a segment decodes): its decode
inbox holds a slot batch's worth of messages beside the in-flight and wrap
allowance.

Because of the engine's RNG contract, a request decoded in whatever slot mix
is resident samples as it would alone, and its tokens equal a solo
``ServingEngine.generate`` of it (``launch.serve.check_served`` holds every
served stream to that).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import make_lock
from repro_torch.cluster.node_manager import StageSpec, WorkflowSpec
from repro_torch.cluster.workflow_set import WorkflowSet
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching import PerRequest
from repro_torch.core.messaging import KVPages
from repro_torch.core.streaming import DEFERRED
from repro_torch.models import registry
from repro_torch.models.param import tree_leaves, tree_unflatten
from repro_torch.serving.engine import ServingEngine

APP_LLM_DISAGG = 7
DEFAULT_RING_BYTES = 1 << 24   # the JAX package's llm_disagg inbox
MESSAGE_SLACK = 1 << 16        # header, meta and page descriptors

_WIRE = {torch.bfloat16: torch.int16}


def to_page(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy page; bfloat16 as its int16 view, bit for bit."""
    t = t.detach().contiguous().cpu()
    return t.view(_WIRE.get(t.dtype, t.dtype)).numpy()


def from_page(page: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The inverse of ``to_page``: a page and its dtype name -> a tensor on
    ``device``."""
    return torch.tensor(page, device=device).view(getattr(torch, dtype))


def largest_message_bytes(cfg: ModelConfig, max_len: int) -> int:
    """Bytes of one prefill -> decode message, from the shapes: the logits
    row, every cache leaf at batch 1 and ``max_len`` positions, and a prompt
    of up to ``max_len`` tokens in the meta."""
    spec = registry.abstract_cache(cfg, 1, max_len)
    cache = sum(int(np.prod(s.shape)) * getattr(torch, s.dtype).itemsize
                for s in tree_leaves(spec))
    prompt = 12 * max_len   # JSON ints
    return MESSAGE_SLACK + 4 * cfg.vocab_padded + cache + prompt


def ring_bytes_for(cfg: ModelConfig, max_len: int, stage: str = "decode",
                   max_slots: int = 1) -> int:
    """Inbox ring size of a stage: room for ``max_slots`` + 3 of its
    largest message (two in flight plus the unusable tail an entry leaves
    when it wraps take up to 3; a decode stage of ``max_slots`` slots may
    hold that many prefilled requests waiting, as it takes one entry per
    segment).  The decode inbox takes whole caches; the prefill inbox takes
    prompts of at most ``max_len`` int32 tokens."""
    if stage == "prefill":
        largest = MESSAGE_SLACK + 4 * max_len
    else:
        largest = largest_message_bytes(cfg, max_len)
    return max(DEFAULT_RING_BYTES, (max_slots + 3) * largest)


def make_prefill_fn(engine: ServingEngine) -> Callable[[Any], Any]:
    """Stage fn for the prefill half.

    Accepts either a raw client payload (``max_batch == 1`` bypass) or the
    coalescer's stacked form (``steps`` then arrives as an ``[N]`` vector),
    and returns one ``KVPages`` per request: page 0 is the last-token logits
    row, pages 1.. are the cache leaves in flatten order, each the request's
    B=1 slice along that leaf's batch axis.  A ``PerRequest`` wrapper keeps
    the per-request pages out of the coalescer's row-slicing.
    """
    axes = [int(a) for a in tree_leaves(engine.batch_axes)]

    def prefill_fn(payload: Dict[str, Any]):
        prompts = np.asarray(payload["prompt"], np.int32)
        stacked = isinstance(payload["steps"], np.ndarray)
        n = prompts.shape[0]
        steps = np.broadcast_to(np.asarray(payload["steps"]), (n,))
        temps = np.broadcast_to(np.asarray(payload.get("temperature", 0.0)), (n,))
        seeds = np.broadcast_to(np.asarray(payload.get("seed", 0)), (n,))
        logits, cache = engine.prefill(prompts)
        leaves = tree_leaves(cache)
        dtypes = ["float32"] + [str(leaf.dtype).removeprefix("torch.")
                                for leaf in leaves]
        out = []
        for i in range(n):
            pages = [to_page(logits[i])] + [
                to_page(leaf.narrow(ax, i, 1)) for leaf, ax in zip(leaves, axes)]
            out.append(KVPages(
                meta={"prompt": prompts[i].tolist(),
                      "start": int(prompts.shape[1]),
                      "steps": int(steps[i]),
                      "temperature": float(temps[i]),
                      "seed": int(seeds[i]),
                      "page_dtypes": dtypes},
                pages=pages))
        return PerRequest(out) if stacked else out[0]

    return prefill_fn


class ContinuousDecoder:
    """The decode half: a continuous stage over a slot-based decode batch.

    ``__call__`` only parks the shipped KV pages (returning ``DEFERRED``);
    the work happens in ``tick()``, on the instance scheduler thread:

      1. admit waiting requests into free slots (``engine.insert_slot``; the
         pages reassemble into the cache tree in flatten order);
      2. run one ``engine.decode_segment`` of ``segment_len`` steps over the
         whole slot batch;
      3. harvest each slot's advanced rows, publish the growing prefix, and
         return finished requests as ``[(uid, tokens [1, P+steps]), ...]``.

    ``abandon()`` releases every slot and reports the orphaned uids so the
    instance can tombstone them.
    """

    continuous = True

    def __init__(self, engine: ServingEngine, *, max_slots: int = 8,
                 segment_len: int = 8,
                 publish: Optional[Callable[[str, np.ndarray], None]] = None,
                 retract: Optional[Callable[[str], None]] = None):
        self.engine = engine
        self.max_slots = max_slots
        self.segment_len = segment_len
        self.publish = publish
        self.retract = retract
        self._lock = make_lock("ContinuousDecoder._lock")
        # guarded_by: _lock -- slot state + queues below
        self._state = engine.init_slots(max_slots)
        self._waiting: deque = deque()          # (uid, KVPages)
        self._slots: Dict[int, Dict[str, Any]] = {}   # slot -> request entry
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self.stats = {"admitted": 0, "completed": 0, "segments": 0,
                      "abandoned": 0, "max_resident": 0}

    def __call__(self, payload: Any, *, uid: str):
        if not isinstance(payload, KVPages):
            raise TypeError(
                f"decode stage expects KVPages, got {type(payload).__name__}")
        with self._lock:
            self._waiting.append((uid, payload))
        return DEFERRED

    def pending(self) -> int:
        with self._lock:
            return len(self._waiting) + len(self._slots)

    def _insert(self, slot: int, kv: KVPages) -> None:
        dev = self.engine.device
        pages = [from_page(p, dt, dev)
                 for p, dt in zip(kv.pages, kv.meta["page_dtypes"])]
        cache1 = tree_unflatten(self.engine.batch_axes, pages[1:])
        self._state = self.engine.insert_slot(
            self._state, slot, cache1, pages[0], start=kv.meta["start"],
            seed=kv.meta["seed"], steps=kv.meta["steps"],
            temperature=kv.meta["temperature"])

    def tick(self) -> List[Tuple[str, Any]]:
        done: List[Tuple[str, np.ndarray]] = []
        partials: List[Tuple[str, np.ndarray]] = []
        with self._lock:
            while self._free and self._waiting:
                uid, kv = self._waiting.popleft()
                slot = self._free.pop()
                self._insert(slot, kv)
                self._slots[slot] = {"uid": uid, "meta": kv.meta, "toks": []}
                self.stats["admitted"] += 1
            if not self._slots:
                return []
            self.stats["max_resident"] = max(self.stats["max_resident"],
                                             len(self._slots))
            self._state, toks, adv = self.engine.decode_segment(
                self._state, self.segment_len)
            self.stats["segments"] += 1
            for slot, ent in list(self._slots.items()):
                fresh = toks[adv[:, slot], slot]
                if fresh.size:
                    ent["toks"].extend(int(t) for t in fresh)
                want = ent["meta"]["steps"]
                if len(ent["toks"]) >= want:
                    tokens = np.asarray(
                        [ent["meta"]["prompt"] + ent["toks"][:want]], np.int32)
                    done.append((ent["uid"], tokens))
                    self._state = self.engine.release_slot(self._state, slot)
                    del self._slots[slot]
                    self._free.append(slot)
                    self.stats["completed"] += 1
                else:
                    partials.append((ent["uid"], np.asarray(
                        [ent["meta"]["prompt"] + ent["toks"]], np.int32)))
        # Hooks run outside the lock: they hit the replicated database,
        # which takes its own locks per replica.
        if self.publish is not None:
            for uid, t in partials:
                self.publish(uid, t)
        if self.retract is not None:
            for uid, _ in done:
                self.retract(uid)
        return done

    def abandon(self) -> List[str]:
        with self._lock:
            uids = [e["uid"] for e in self._slots.values()]
            uids += [u for u, _ in self._waiting]
            for slot in list(self._slots):
                self._state = self.engine.release_slot(self._state, slot)
                self._free.append(slot)
            self._slots.clear()
            self._waiting.clear()
            self.stats["abandoned"] += len(uids)
        if self.retract is not None:
            for uid in uids:
                self.retract(uid)
        return uids


def build_llm_disagg_set(
    engine: ServingEngine,
    *,
    name: str = "llm",
    max_slots: int = 8,
    segment_len: int = 8,
    prefill_batch: int = 1,
) -> Tuple[WorkflowSet, "ContinuousDecoder"]:
    """Wire a two-stage llm_disagg Workflow Set around one engine: one
    prefill instance (coalescing up to ``prefill_batch`` prompts) and one
    decode instance running a ``max_slots``-wide ``ContinuousDecoder``, both
    stage fns inline on their scheduler threads, no elastic control loop.

    The prefill inbox holds four of the largest message it receives, the
    decode inbox ``max_slots`` + 3 (``ring_bytes_for``: a decode message is
    a whole B=1 cache at ``max_len``).  The decoder publishes per-segment
    partials to the set's replicated database and purges them on
    completion.  Returns ``(set, decoder)``.
    """
    ws = WorkflowSet(name, control_loop=False)
    db = ws.database

    def publish(uid: str, tokens: np.ndarray) -> None:
        db.store(f"partial/{uid}", tokens)

    def retract(uid: str) -> None:
        db.purge(f"partial/{uid}")

    decoder = ContinuousDecoder(engine, max_slots=max_slots,
                                segment_len=segment_len,
                                publish=publish, retract=retract)
    ws.register_workflow(WorkflowSpec(APP_LLM_DISAGG, "llm_disagg", [
        StageSpec("prefill", fn=make_prefill_fn(engine), exec_time_s=0.01,
                  deps=[]),
        StageSpec("decode", fn=decoder, exec_time_s=0.05, deps=["prefill"]),
    ]))
    ws.add_instance("prefill0", stage="prefill", max_batch=prefill_batch,
                    max_wait_s=0.004, pad_to_full=prefill_batch > 1, inline=True,
                    ring_bytes=ring_bytes_for(engine.cfg, engine.max_len, "prefill"))
    ws.add_instance("decode0", stage="decode", max_batch=1, inline=True,
                    ring_bytes=ring_bytes_for(engine.cfg, engine.max_len,
                                              max_slots=max_slots))
    ws.add_proxy("p0")
    return ws, decoder
