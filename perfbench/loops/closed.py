"""The closed loop in passes: a scheduler working through a deep queue.

Two passes of ``pass_size`` requests are in flight, one being solved and
one queued; the next pass is sent once the engine has taken the queued
one, so that no pass is split between two dispatches, and its requests
are made while the card solves.  The first pass is queued whole before
the flusher starts, so that every group of it goes to the card in one
dispatch; it builds and warms every kernel the cell uses.  The second
waits for it, as no later pass waits.  So the window opens at the
completion of the second pass and closes at the completion of the first
pass that ends ``seconds`` after it: it holds whole dispatches, each of
whose requests waited as in a steady backlog.  A traced run profiles the
pass still in flight at the close, so that the profiler's start and stop
fall outside the window.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Tuple

import numpy as np

from perfbench.harness import (FIRST_PASS_S, LATE_S, Answer, Window,
                               card_state, counters)

POLL_S = 0.0005


class Loop:
    def __init__(self, engine, stream, config: dict, mix: dict) -> None:
        self.engine, self.stream = engine, stream
        self.algorithm = config["algorithm"]
        self.ready = stream.next_pass()
        self.passes: Deque[Tuple[int, List[Answer]]] = deque()
        self.answers: List[Answer] = []
        self.sent = 0
        self.deadline = time.monotonic() + FIRST_PASS_S

    def taken(self) -> int:
        s = self.engine.stats
        return s.full_bucket_flushes + s.deadline_flushes

    def submit(self) -> None:
        """Send the next pass, then make the one after it."""
        from repro_torch.serve.mapper import MapRequest
        mark, out = self.taken(), []
        for r in self.ready:
            a = Answer(r, self.sent, time.monotonic())
            a.future = self.engine.submit(MapRequest(
                job_id=r.job_id, C=r.C, M=r.M, algorithm=self.algorithm,
                seed=r.seed))
            out.append(a)
        self.sent += 1
        self.answers.extend(out)
        self.passes.append((mark, out))
        self.ready = self.stream.next_pass()

    def wait_taken(self, deadline: float) -> None:
        """Until the engine has taken the newest pass."""
        mark = self.passes[-1][0]
        while self.taken() <= mark:
            if time.monotonic() > deadline:
                raise TimeoutError("the engine took no pass")
            time.sleep(POLL_S)

    def collect(self, deadline: float) -> Tuple[int, float]:
        """Wait for the oldest pass: its number and completion time (the
        time of giving up, where an answer never came)."""
        _, out = self.passes.popleft()
        for a in out:
            try:
                resp = a.future.result(
                    timeout=max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                a.error = "no answer"
                continue
            except Exception as e:           # the engine failed this group
                a.error = repr(e)
                continue
            a.t_done = time.monotonic()
            a.perm, a.objective = np.asarray(resp.perm), resp.objective
            a.seconds, a.batch_size = resp.seconds, resp.batch_size
            a.bucket = resp.bucket
        if any(a.t_done is None for a in out):
            return out[0].pass_no, time.monotonic()
        return out[0].pass_no, max(a.t_done for a in out)

    def run(self, seconds: float, tracer, device: str) -> Window:
        marks = [time.monotonic()]
        self.submit()
        time.sleep(self.engine.flush_deadline_ms / 1000.0)
        self.engine.start()
        self.deadline = time.monotonic() + FIRST_PASS_S
        self.wait_taken(self.deadline)
        self.submit()
        t_open = None
        while True:
            pass_no, done = self.collect(self.deadline)
            marks.append(done)
            if t_open is None:
                if pass_no == 1:
                    t_open, before = done, counters(self.engine)
                    card_open = card_state(device)
                    self.deadline = t_open + seconds + LATE_S
            elif done >= t_open + seconds:
                after, closing = counters(self.engine), pass_no
                card_close = card_state(device)
                break
            if t_open is None or done < t_open + seconds:
                self.wait_taken(self.deadline)
                self.submit()
        traced = []
        if tracer is not None and self.passes:     # in flight at the close
            tracer.start()
            tracer.begin()
            pass_no, _ = self.collect(self.deadline)
            tracer.end()
            tracer.stop()
            traced = [a for a in self.answers if a.pass_no == pass_no]
        log = (f"first pass {marks[1] - marks[0]:.3f} s, second pass "
               f"{marks[2] - marks[1]:.3f} s; window {done - t_open:.3f} s, "
               f"passes 2-{closing} "
               f"{[round(b - a, 3) for a, b in zip(marks[2:], marks[3:])]} s;"
               f" at its opening {card_open}; at its close {card_close}")
        return Window(
            t_first=marks[0], t_open=t_open, t_close=done,
            answers=[a for a in self.answers
                     if 1 < a.pass_no <= closing and a.error is None],
            before=before, after=after, traced=traced, log=log)

    def drain(self) -> List[Answer]:
        """Every request sent, once the engine has stopped and served what
        was still queued."""
        while self.passes:
            self.collect(self.deadline)
        return self.answers
