"""Serving engine of the port: continuous-batching generation.

The slot runtime of ``repro.engine.engine``:

  * a fixed slot-batched decode cache (``init_cache(..., per_slot_pos=True)``)
    — every slot decodes at its own depth; each decode step writes every
    slot's new K/V row (MLA: its latent and rope-key row) and/or its new
    SSM state in place (a hybrid model has both)
  * prefill runs per request (B=1, right-padded to a multiple of
    ``PREFILL_ALIGN``) and is copied into its slot of every cache leaf
  * decode steps run over all slots every tick; idle slots are parked at
    position 0 and decode garbage that the next insert overwrites

An encoder-decoder config is refused (``NotImplementedError``): the
reference's engine cannot build its cache either (its enc-dec
``init_cache`` takes no ``per_slot_pos`` and it fails with a TypeError).
A VLM config serves text only, as in the reference, whose prefill passes
``tokens`` alone.

As in the reference, the first generated token is the argmax of the logits
at the last *padded* prompt position, so greedy outputs match it token for
token. In an SSM the pad tokens also run through the recurrence, so the
state spliced into the slot has seen them; the port keeps that too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer

PREFILL_ALIGN = 16


@dataclasses.dataclass
class Request:
    rid: int
    prompt: str
    max_new_tokens: int = 32
    temperature: float = 0.0
    # filled during processing
    prompt_ids: Optional[list] = None
    output_ids: Optional[list] = None
    slot: int = -1
    prefill_s: float = 0.0
    submitted_s: float = 0.0
    started_s: float = 0.0      # slot insert (service start, not enqueue)
    done_s: float = 0.0

    @property
    def text(self) -> str:
        return ByteTokenizer().decode(self.output_ids or [])


class GenerationEngine:
    def __init__(self, bundle, params, *, max_len: int = 256,
                 n_slots: int = 4, dtype=torch.float32, device="cuda",
                 tokenizer: Optional[ByteTokenizer] = None):
        if bundle.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{bundle.cfg.name}: the engine serves decoder-only models; "
                f"an encoder-decoder's cache (the encoder's keys and values, "
                f"one shared position) has no per-slot form, and the "
                f"reference's engine cannot build it either")
        self.bundle = bundle
        self.params = params
        self.max_len = max_len
        self.n_slots = n_slots
        self.dtype = dtype
        self.device = torch.device(device)
        self.tok = tokenizer or ByteTokenizer()
        self.cache = bundle.init_cache(n_slots, max_len, dtype=dtype,
                                       per_slot_pos=True, device=self.device)
        self.last_token = torch.zeros((n_slots, 1), dtype=torch.long,
                                      device=self.device)
        self.active = np.zeros((n_slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.stats = {"decode_steps": 0, "prefills": 0, "occupancy_sum": 0.0,
                      "decode_s": 0.0, "prefill_s": 0.0}

    def free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self.active[i]]

    @torch.no_grad()
    def insert(self, req: Request, slot: int) -> Optional[Request]:
        """Prefill one request and copy it into its slot. Returns the request
        if it finished at prefill (prompt fills the window)."""
        t0 = time.perf_counter()
        req.started_s = t0
        ids = self.tok.encode(req.prompt)[: self.max_len - 1]
        req.prompt_ids = ids
        req.output_ids = []
        req.slot = slot
        tokens = torch.as_tensor(self.tok.pad_batch([ids], align=PREFILL_ALIGN),
                                 device=self.device)
        logits, cache1 = self.bundle.prefill(self.params, {"tokens": tokens},
                                             max_len=self.max_len,
                                             dtype=self.dtype)
        # every leaf but pos has the slot (batch) axis at dim 1: K/V for
        # GQA layers, ckv and krope for MLA ones, ssm_state and conv_buf for
        # SSM layers, K/V and both SSM leaves for hybrid ones
        for name, leaf in self.cache.items():
            if name != "pos":
                leaf[:, slot] = cache1[name][:, 0]
        # prefill padded the prompt; the next position is len(ids)
        self.cache["pos"][slot] = len(ids)
        nxt = torch.argmax(logits[0, -1])
        self.last_token[slot, 0] = nxt
        req.output_ids.append(int(nxt))
        self.stats["prefills"] += 1
        req.prefill_s = time.perf_counter() - t0
        self.stats["prefill_s"] += req.prefill_s
        if (len(ids) + 1 >= self.max_len
                or len(req.output_ids) >= req.max_new_tokens):
            req.done_s = time.perf_counter()
            return req                      # finished at prefill
        self.active[slot] = True
        self.slot_req[slot] = req
        return None

    @torch.no_grad()
    def decode_tick(self, generator: Optional[torch.Generator] = None
                    ) -> List[Request]:
        """One decode step across all slots; returns finished requests.
        ``generator`` (on the engine's device) draws the Gumbel noise of
        this tick's temperature sampling."""
        t0 = time.perf_counter()
        logits, self.cache = self.bundle.decode_step(
            self.params, self.cache, self.last_token, dtype=self.dtype)
        # keep idle slots parked at position 0 (their writes are overwritten
        # by the next insert; parking avoids pos growing past max_len)
        active = torch.as_tensor(self.active, device=self.device)
        pos = torch.where(active, self.cache["pos"],
                          torch.zeros_like(self.cache["pos"]))
        self.cache["pos"] = pos.clamp(max=self.max_len - 1)

        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1)
        if generator is not None:
            temps = np.array([self.slot_req[i].temperature
                              if self.slot_req[i] else 0.0
                              for i in range(self.n_slots)], np.float32)
            if (temps > 0).any():
                u = torch.rand(last.shape, generator=generator,
                               device=last.device)
                gumbel = -torch.log(-torch.log(
                    u.clamp_min(torch.finfo(torch.float32).tiny)))
                t = torch.as_tensor(temps, device=last.device)
                samp = torch.argmax(
                    last / t.clamp_min(1e-6)[:, None] + gumbel, dim=-1)
                nxt = torch.where(t > 0, samp, nxt)
        self.last_token = nxt[:, None]
        nxt_host = nxt.cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += float(self.active.mean())
        self.stats["decode_s"] += time.perf_counter() - t0

        done: List[Request] = []
        for i in range(self.n_slots):
            req = self.slot_req[i]
            if req is None or not self.active[i]:
                continue
            req.output_ids.append(int(nxt_host[i]))
            eos = nxt_host[i] == self.tok.eos_id
            full = len(req.output_ids) >= req.max_new_tokens
            over = len(req.prompt_ids) + len(req.output_ids) >= self.max_len
            if eos or full or over:
                req.done_s = time.perf_counter()
                self.active[i] = False
                self.slot_req[i] = None
                done.append(req)
        return done

    @property
    def occupancy(self) -> float:
        n = max(1, self.stats["decode_steps"])
        return self.stats["occupancy_sum"] / n


class ContinuousBatcher:
    """Request queue + slot scheduler over a GenerationEngine."""

    def __init__(self, engine: GenerationEngine):
        self.engine = engine
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    def submit(self, prompt: str, max_new_tokens: int = 32,
               temperature: float = 0.0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens, temperature,
                                  submitted_s=time.perf_counter()))
        return rid

    def _fill_slots(self) -> None:
        for slot in self.engine.free_slots():
            if not self.queue:
                break
            done = self.engine.insert(self.queue.pop(0), slot)
            if done is not None:
                self.finished[done.rid] = done

    def step(self, generator: Optional[torch.Generator] = None) -> bool:
        """One scheduling round: fill free slots from the queue, then one
        decode tick. Returns True while work remains."""
        self._fill_slots()
        if self.engine.active.any():
            for req in self.engine.decode_tick(generator):
                self.finished[req.rid] = req
        return bool(self.queue or self.engine.active.any())

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[int, Request]:
        """Drive to completion, one ``step`` per round. A generator advances
        with every tick, so each tick draws fresh sampling noise."""
        while self.step(generator):
            pass
        return self.finished
