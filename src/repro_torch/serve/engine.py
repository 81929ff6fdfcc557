"""Serving engine: continuous batching over a paged or a dense KV cache (a
port of ``repro.serve.engine``).

Two cache layouts share the same scheduler surface, as in the reference:

* **paged** (default): global-attention K/V live in a fixed pool of
  ``page_size``-token pages (``serve/paging.py`` owns the free list and the
  per-request block tables); every other cache leaf (sliding-window ring
  caches, RG-LRU and xLSTM state) is per slot, and a model without global
  attention (xLSTM) pools nothing. Requests admit the moment a slot AND
  pages are free, a finished request's pages free immediately, and pool
  exhaustion mid-decode preempts the youngest request (free its pages,
  requeue, re-prefill prompt + output later: recompute preemption).
  Prompts longer than ``prefill_chunk`` optionally prefill in chunk-sized
  pieces interleaved with decode steps (block patterns that support it);
  slots whose next chunk has the same (start, length, table width) advance
  in one batched call.
* **dense** (``page_size=0``): every slot reserves ``max_len`` positions of
  every cache leaf; decode runs through kernel K3. The reference the paged
  layout is proven token-exact against.

Where the JAX engine donates the cache through every jitted step so XLA
updates it in place, the port's model writes the cache tensors in place
(``index_put_``, ``copy_``) and the engine keeps the same ``self.cache``.
Where it jit-compiles each step once per shape, the port captures each
decode and chunk step once per shape signature as a CUDA graph and replays
it (``serve/step_graph.py``; ``graphs=False`` runs the same step eagerly,
as the CPU does). The whole-prompt prefill stays eager: prompt lengths
vary per request, and a graph per length would hold an activation pool per
length.

With the process tracer on (``repro_torch.obs``), prefill, chunk and decode
steps emit spans under the invocation whose batch runs them, at the
reference's sites and with its end points: a decode span ends after the
host reads the step's tokens; a paged prefill span and every chunk span
end when their work is dispatched (no synchronisation is added; the
first token is read after the span).

Greedy decoding is the default. Sampling seeds a ``torch.Generator`` from
(seed, req_id, attempt, position): a new delivery attempt draws fresh
randomness, while a preemption resume (same attempt, same positions)
replays the identical stream. The draws are not JAX's threefry bits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import AbstractSet, Deque, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.obs import TRACER, torch_profile
from repro_torch.serve.paging import BlockAllocator, pages_for
from repro_torch.serve.step_graph import StepGraphs

DEFAULT_PAGE_SIZE = 16

# slot lifecycle (paged scheduler)
IDLE, PREFILL, DECODE = "idle", "prefill", "decode"


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    req_id: int = 0
    # at-least-once delivery attempt (folded into the sampling seed)
    attempt: int = 0
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: Optional[float] = None    # wall clock, for TTFT accounting
    t_first: Optional[float] = None


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _sample_key(seed: int, req_id: int, attempt: int, position: int) -> int:
    """Generator seed for one draw: a stable hash of the four keys."""
    key = f"{seed}/{req_id}/{attempt}/{position}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") >> 1


def install_slot(cache, slot_cache, slot: int,
                 pages: Optional[torch.Tensor] = None,
                 pooled: AbstractSet[str] = frozenset()) -> None:
    """Install a B=1 prefill cache into the engine's cache, in place: each
    per-slot leaf is written into ``slot``; each pooled global-attention
    K/V leaf (path in ``pooled``) scatters its rows of positions
    [0, npages * page) to ``pages`` in order, zero-padded past the prompt."""
    for (path, big), (_, small) in zip(iter_leaves(cache),
                                       iter_leaves(slot_cache)):
        ax = M.slot_batch_axis(path)
        seg = small.select(ax, 0)
        if path not in pooled:
            big.select(ax, slot).copy_(seg)
            continue
        # seg: (n_periods, L, KV, hd) under blocks/, (L, KV, hd) under rem/;
        # big: (n_periods, num_pages, page, KV, hd) or (num_pages, page, ..)
        npages, page = pages.shape[0], big.shape[-3]
        span = npages * page
        if span > seg.shape[ax]:
            seg = F.pad(seg, (0, 0, 0, 0, 0, span - seg.shape[ax]))
        seg = seg.narrow(ax, 0, span)
        seg = seg.reshape(seg.shape[:ax] + (npages, page) + seg.shape[ax + 1:])
        if ax == 1:
            big[:, pages] = seg.to(big.dtype)
        else:
            big[pages] = seg.to(big.dtype)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_len: int = 256, impl: Optional[str] = None,
                 greedy: bool = True,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 kv_pool_tokens: Optional[int] = None,
                 prefill_chunk: int = 0,
                 sample_seed: int = 0,
                 device: DeviceLike = None,
                 graphs: bool = True):
        """``device`` defaults to the card and must hold ``params``.
        ``page_size=0`` selects the dense per-slot cache; otherwise
        global-attention K/V are paged. ``kv_pool_tokens`` sizes the shared
        pool (default max_slots * max_len); smaller pools oversubscribe and
        rely on preemption. ``prefill_chunk`` > 0 prefills prompts longer
        than the chunk in chunk-sized pieces interleaved with decode (paged
        layout, supported block patterns only). ``impl="ref"`` runs the
        plain kernel versions instead of the kernels. ``graphs`` (the card
        only) captures each decode and chunk step once per shape signature
        and replays it; False runs every step eagerly. An encoder-decoder
        raises: the engine passes no frames, as the reference's, which fails
        at its first prefill instead."""
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: the serving engine does not serve "
                "encoder-decoders (it has no frames to encode); run "
                "models.model.prefill / decode_step with batch['frames']")
        self.device = resolve_device(device)
        w = params["embed"]["tok"]
        if w.device.type != self.device.type:
            raise ValueError(f"params are on {w.device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.impl = impl
        self.greedy = greedy
        self.paged = page_size > 0
        self.prefill_chunk = int(prefill_chunk)
        self.sample_seed = sample_seed
        self.step_graphs = StepGraphs(self.device, capture=graphs)

        self.pos = np.zeros((max_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * max_slots
        self.last_token = np.zeros((max_slots,), np.int32)
        self.waiting: Deque[Request] = deque()
        self.n_prefills = 0
        self.n_prefill_chunks = 0
        self.n_decode_steps = 0
        self.n_evictions = 0
        # host-clock measurements (each ends in a device->host read)
        self.ttft_s: List[float] = []
        self.decode_s = 0.0

        if not self.paged:
            self.cache = M.init_cache(cfg, max_slots, max_len,
                                      device=self.device)
            return
        self.page = int(page_size)
        self.pages_per_seq = pages_for(max_len, self.page)
        pool = (pages_for(kv_pool_tokens, self.page) if kv_pool_tokens
                else max_slots * self.pages_per_seq)
        self.num_pages = pool + 1           # + the reserved scratch page
        self.allocator = BlockAllocator(self.num_pages, self.page,
                                        reserved=(0,))
        self.cache = M.init_paged_cache(cfg, max_slots, max_len,
                                        self.num_pages, self.page,
                                        device=self.device)
        self._pooled = {path for (path, _), paged in zip(
            iter_leaves(self.cache), M.paged_leaf_flags(cfg, self.cache))
            if paged}
        self._chunk_ok = (self.prefill_chunk > 0
                          and M.chunked_prefill_supported(cfg))
        self._state = [IDLE] * max_slots
        self._seq: Dict[int, List[int]] = {}      # slot -> prefill seq
        self._progress: Dict[int, int] = {}       # slot -> prefilled upto
        self._admit_order: List[int] = []         # eviction priority

    # ------------------------------------------------------------------
    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _sample_token(self, logits_row: torch.Tensor, req: Request) -> int:
        if self.greedy:
            return int(torch.argmax(logits_row))
        gen = torch.Generator()
        gen.manual_seed(_sample_key(self.sample_seed, req.req_id, req.attempt,
                                    len(req.prompt) + len(req.output)))
        probs = torch.softmax(logits_row.detach().float().cpu(), dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _record_token(self, slot: int, req: Request, tok: int) -> None:
        req.output.append(tok)
        if req.t_first is None:
            req.t_first = time.perf_counter()
            if req.t_submit is not None:
                self.ttft_s.append(req.t_first - req.t_submit)
        self.last_token[slot] = tok

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def submit(self, req: Request) -> None:
        """Queue a request; the scheduler admits it when a slot and pages
        free up (paged layout: requests that could NEVER fit are
        rejected)."""
        if self.paged:
            if len(req.prompt) >= self.max_len:
                raise ValueError(f"prompt length {len(req.prompt)} >= "
                                 f"max_len {self.max_len}")
            need = pages_for(min(len(req.prompt) + req.max_new_tokens,
                                 self.max_len), self.page)
            if need > self.num_pages - 1:
                raise ValueError(
                    f"request footprint of {need} pages exceeds the pool "
                    f"({self.num_pages - 1} pages); it could never run")
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.waiting.append(req)

    def admit(self, req: Request) -> bool:
        """Place ``req`` into a free slot now (False: no slot / no pages).
        Long prompts start chunked prefill (paged layout); otherwise the
        whole prompt prefills before this returns."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        slots = self.free_slots()
        if not slots:
            return False
        slot = slots[0]
        if not self.paged:
            t0 = TRACER.now() if TRACER.enabled else 0.0
            prompt = self._tensor(np.asarray(req.prompt, np.int32)[None, :])
            logits, slot_cache = M.prefill(self.cfg, self.params,
                                           {"tokens": prompt},
                                           cache_len=self.max_len,
                                           impl=self.impl)
            install_slot(self.cache, slot_cache, slot)
            self._record_token(slot, req, self._sample_token(logits[0, -1],
                                                             req))
            self.active[slot] = req
            self.pos[slot] = len(req.prompt)
            self.n_prefills += 1
            self._trace_span("prefill", t0, len(req.prompt))
            return True
        # resume-aware: a preempted request re-prefills prompt + all output
        # but the last sampled token (the next decode input)
        seq = list(req.prompt) + list(req.output[:-1])
        if not self.allocator.ensure(slot, len(seq)):
            return False
        self.active[slot] = req
        self._admit_order.append(slot)
        if self._chunk_ok and len(seq) > self.prefill_chunk:
            self._state[slot] = PREFILL
            self._seq[slot] = seq
            self._progress[slot] = 0
            self.pos[slot] = 0
            return True
        self._full_prefill(slot, req, seq)
        return True

    def _full_prefill(self, slot: int, req: Request, seq: List[int]) -> None:
        t0 = TRACER.now() if TRACER.enabled else 0.0
        prompt = self._tensor(np.asarray(seq, np.int32)[None, :])
        pages = self._tensor(np.asarray(
            self.allocator.table(slot)[:pages_for(len(seq), self.page)],
            np.int64))
        logits, dense = M.prefill(self.cfg, self.params, {"tokens": prompt},
                                  cache_len=self.max_len, impl=self.impl)
        install_slot(self.cache, dense, slot, pages, self._pooled)
        self.n_prefills += 1
        self._trace_span("prefill", t0, len(seq))
        self._finish_prefill(slot, req, seq, logits)

    def _finish_prefill(self, slot: int, req: Request, seq: List[int],
                        logits) -> None:
        self._state[slot] = DECODE
        self.pos[slot] = len(seq)
        if req.output:                       # preemption resume
            self.last_token[slot] = req.output[-1]
        else:
            self._record_token(slot, req,
                               self._sample_token(logits[0, -1], req))

    # ------------------------------------------------------------------
    def _advance_chunks(self) -> None:
        """Advance every mid-prefill slot by one chunk; slots whose next
        chunk shares a (start, length, table-width) signature advance in
        ONE batched call."""
        groups: Dict[tuple, List[int]] = {}
        for slot in self._admit_order:
            if self._state[slot] != PREFILL:
                continue
            seq, p = self._seq[slot], self._progress[slot]
            C = min(self.prefill_chunk, len(seq) - p)
            width = min(_next_pow2(pages_for(p + C, self.page)),
                        max(self.pages_per_seq, 1))
            groups.setdefault((p, C, width), []).append(slot)
        for (p, C, width), members in groups.items():
            self._chunk_group(members, p, C, width)

    def _trace_span(self, name: str, t0: float, tokens: int) -> None:
        """Close one engine span against the batch executor's thread-local
        trace context (how prefill/decode steps land under the owning
        invocation's ``execute`` span); no-op untraced."""
        if TRACER.enabled and TRACER.current() is not None:
            TRACER.complete(name, t0, TRACER.now(),
                            attrs={"tokens": int(tokens)})

    def _chunk_group(self, members: List[int], p: int, C: int,
                     width: int) -> None:
        kb = _next_pow2(len(members))
        rows = members + [members[-1]] * (kb - len(members))
        piece = np.zeros((kb, C), np.int32)
        table = np.zeros((kb, width), np.int32)
        for r, slot in enumerate(rows):
            piece[r] = self._seq[slot][p:p + C]
            tab = self.allocator.table(slot)[:width]
            table[r, :len(tab)] = tab
        t0 = TRACER.now() if TRACER.enabled else 0.0
        logits = self.step_graphs.run(
            ("chunk", kb, C, width),
            (piece, np.int32(p), table, np.asarray(rows, np.int64)),
            self._chunk_step)
        self.n_prefill_chunks += len(members)
        self._trace_span("prefill_chunk", t0, C * len(members))
        finished = [(r, s) for r, s in enumerate(members)
                    if p + C == len(self._seq[s])]
        for slot in members:
            if p + C < len(self._seq[slot]):
                self._progress[slot] = p + C
        for r, slot in finished:
            req, seq = self.active[slot], self._seq[slot]
            del self._seq[slot], self._progress[slot]
            self.n_prefills += 1
            self._finish_prefill(slot, req, seq, logits[r:r + 1])

    def _chunk_step(self, piece, start, table, idx):
        """One chunk of the rows ``idx`` at ``start`` (all on the card): the
        chunk step's program. Per-slot leaves gather the group's rows along
        the batch axis and scatter back after the chunk; duplicate padding
        rows re-write identical values. Pools are updated in place."""
        view = map_tree(lambda path, leaf: leaf if path in self._pooled
                        else leaf.index_select(M.slot_batch_axis(path), idx),
                        self.cache)
        logits, view = M.prefill_chunk(self.cfg, self.params, view, piece,
                                       start, table, impl=self.impl)
        for (path, big), (_, small) in zip(iter_leaves(self.cache),
                                           iter_leaves(view)):
            if path not in self._pooled:
                big.index_copy_(M.slot_batch_axis(path), idx, small)
        return logits

    # ------------------------------------------------------------------
    def _pick_victim(self, exclude: int) -> Optional[int]:
        for i in reversed(self._admit_order):
            if i != exclude:
                return i
        return None

    def _evict(self, slot: int) -> None:
        """Recompute preemption: free the slot's pages and requeue the
        request at the FRONT of the waiting queue (generated tokens kept;
        re-admission re-prefills prompt + output)."""
        req = self.active[slot]
        self.allocator.free(slot)
        self.active[slot] = None
        self._state[slot] = IDLE
        self._admit_order.remove(slot)
        self._seq.pop(slot, None)
        self._progress.pop(slot, None)
        self.pos[slot] = 0
        self.last_token[slot] = 0
        self.waiting.appendleft(req)
        self.n_evictions += 1

    def _release(self, slot: int) -> None:
        self.active[slot] = None
        self._state[slot] = IDLE
        self._admit_order.remove(slot)
        self.allocator.free(slot)
        self.pos[slot] = 0
        self.last_token[slot] = 0

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduler step; returns requests finished by it. Paged: admit
        waiting requests into free slots, advance one prefill chunk, then
        one decode step for every decoding slot (with page growth /
        preemption beforehand). Dense: one decode step over the slots.
        Traced, the step is a ``serve.step`` profiler range."""
        if TRACER.enabled:
            with torch_profile("serve.step"):
                return self._step()
        return self._step()

    def _step(self) -> List[Request]:
        if not self.paged:
            return self._step_decode_dense()
        while self.waiting and self.free_slots():
            if not self.admit(self.waiting[0]):
                break
            self.waiting.popleft()
        self._advance_chunks()
        return self._decode_once()

    def _decode_call(self, key: tuple, arrays, n_rows: int):
        """One model decode step over every row (``n_rows`` of them live):
        the program of signature ``key`` on the host ``arrays``; returns the
        logits and the greedy tokens on the host (the step's one
        synchronisation). The logits are valid until the engine's next
        decode or chunk step (``StepGraphs.run``)."""
        t_span = TRACER.now() if TRACER.enabled else 0.0
        t0 = time.perf_counter()
        logits, greedy = self.step_graphs.run(key, arrays, self._decode_step)
        self.n_decode_steps += 1
        greedy_tok = greedy.cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self._trace_span("decode", t_span, n_rows)
        return logits, greedy_tok

    def _decode_step(self, tokens, pos, block_tables=None, mask=None):
        """The decode step's program: (logits, greedy tokens) on the card."""
        logits, _ = M.decode_step(
            self.cfg, self.params, self.cache, tokens[:, None], pos,
            impl=self.impl, block_tables=block_tables, mask=mask)
        return logits, torch.argmax(logits[:, 0], dim=-1)

    def _emit(self, slot: int, logits, greedy_tok) -> bool:
        """Record the token a decode step gave ``slot``; True when its
        request is done."""
        req = self.active[slot]
        self.pos[slot] += 1
        tok = int(greedy_tok[slot]) if self.greedy else \
            self._sample_token(logits[slot, 0], req)
        self._record_token(slot, req, tok)
        req.done = tok == EOS or len(req.output) >= req.max_new_tokens or \
            int(self.pos[slot]) >= self.max_len - 1
        return req.done

    def _step_decode_dense(self) -> List[Request]:
        """Every slot decodes (idle ones on stale state, harmlessly: an
        admission rewrites the whole slot)."""
        if all(r is None for r in self.active):
            return []
        logits, greedy_tok = self._decode_call(
            ("dense",), (self.last_token, self.pos),
            sum(r is not None for r in self.active))
        finished = []
        for i, req in enumerate(self.active):
            if req is not None and self._emit(i, logits, greedy_tok):
                finished.append(req)
                self.active[i] = None
        return finished

    def _decode_once(self) -> List[Request]:
        decoding = [i for i in range(self.max_slots)
                    if self._state[i] == DECODE]
        if not decoding:
            return []
        # page growth for this step's writes; preempt youngest on exhaustion
        skipped = set()
        for i in list(decoding):
            if self._state[i] != DECODE:
                continue                    # evicted by an earlier growth
            while not self.allocator.ensure(i, int(self.pos[i]) + 1):
                victim = self._pick_victim(exclude=i)
                if victim is None:
                    victim = i              # alone and out of pages
                self._evict(victim)
                if victim == i:
                    skipped.add(i)
                    break
        decoding = [i for i in decoding
                    if self._state[i] == DECODE and i not in skipped]
        if not decoding:
            return []

        # rows of idle or mid-prefill slots carry token 0 at position 0 and
        # an all-zeros table: their pool writes land in scratch page 0, and
        # ``mask`` keeps their per-slot leaves unchanged
        mask = np.zeros((self.max_slots,), bool)
        mask[decoding] = True
        width = min(
            _next_pow2(max(self.allocator.pages_used(i) for i in decoding)),
            max(self.pages_per_seq, 1))
        tables = np.zeros((self.max_slots, width), np.int32)
        for i in decoding:
            tab = self.allocator.table(i)
            tables[i, :len(tab)] = tab
        logits, greedy_tok = self._decode_call(
            ("decode", width),
            (np.where(mask, self.last_token, 0).astype(np.int32),
             np.where(mask, self.pos, 0).astype(np.int32), tables, mask),
            len(decoding))

        finished = []
        for i in decoding:
            req = self.active[i]
            if self._emit(i, logits, greedy_tok):
                finished.append(req)
                self._release(i)
        return finished

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Instance-lifetime counters (the JAX engine's stats)."""
        s = {"n_prefills": self.n_prefills,
             "n_decode_steps": self.n_decode_steps,
             "active_slots": sum(r is not None for r in self.active),
             "max_slots": self.max_slots}
        if not self.paged:
            s["paged"] = 0
            return s
        s.update({"paged": 1, "page_size": self.page,
                  "n_pages": self.num_pages - 1,
                  "pages_free": self.allocator.n_free,
                  "n_prefill_chunks": self.n_prefill_chunks,
                  "n_evictions": self.n_evictions,
                  "waiting": len(self.waiting)})
        return s

    # ------------------------------------------------------------------
    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests to completion (continuous batching).
        The engine launches on its own card, whatever the calling thread's
        current device (it is per thread, and a gateway worker serving this
        warm engine may have entered another)."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._generate(requests)
        return self._generate(requests)

    def _generate(self, requests: List[Request]) -> List[Request]:
        if not self.paged:
            now = time.perf_counter()
            for r in requests:          # queueing counts toward TTFT
                if r.t_submit is None:
                    r.t_submit = now
            waiting = list(requests)
            done: List[Request] = []
            while waiting or any(r is not None for r in self.active):
                while waiting and self.free_slots():
                    self.admit(waiting.pop(0))
                done.extend(self._step_decode_dense())
            return done

        for req in requests:
            self.submit(req)
        done = []
        while self.waiting or any(s != IDLE for s in self._state):
            before = (self.n_prefills, self.n_prefill_chunks,
                      self.n_decode_steps, len(self.waiting))
            done.extend(self.step())
            after = (self.n_prefills, self.n_prefill_chunks,
                     self.n_decode_steps, len(self.waiting))
            if after == before:     # no admission, no chunk, no decode
                raise RuntimeError("paged scheduler stalled "
                                   f"(stats: {self.stats()})")
        return done

    def generate_many(self, groups: List[List[Request]]
                      ) -> List[List[Request]]:
        """Serve several invocations' request groups through ONE shared
        continuous-batching stream; returns finished requests regrouped
        per input group (completion order within each group)."""
        owner: Dict[int, int] = {}
        merged: List[Request] = []
        for gi, group in enumerate(groups):
            for req in group:
                owner[id(req)] = gi
                merged.append(req)
        done = self.generate(merged)
        out: List[List[Request]] = [[] for _ in groups]
        for req in done:
            out[owner[id(req)]].append(req)
        return out
