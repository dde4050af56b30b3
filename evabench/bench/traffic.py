"""Closed-loop traffic from a data file of parameters.

A traffic file (``evabench/traffic/<name>.json``) holds::

    {"loop": "closed", "clients": 8, "think_s": 0,
     "prompt_len": [64, 512], "output_len": [256, 1024],
     "strata": 16, "first_output_len": [1, 1024]}

and names the public statistics its lengths come from (``source``, ``why``:
read by people, not by the generator).

Every client sends its next request as soon as its last one has finished
(``think_s`` is 0: the generator has no think time). Lengths are uniform over the closed ranges, drawn by
stratification: each block of ``strata`` consecutive requests takes the
``strata`` mid-points of equal slices of the range, in an order that the
seed shuffles (prompt and output lengths shuffled apart). So every seed
serves the same set of sizes, in another order, and the seed changes
which tokens are sent, not how much work they are. The first request of
each client has an output length from ``first_output_len``, stratified
over the clients in an order the seed shuffles, so that the first
completions spread over the window instead of coming together. Token ids
are uniform over ``[0, vocab)``. Every request is greedy and has no stop
ids: it runs to its drawn length.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

# keys a traffic file must hold
REQUIRED = ("loop", "clients", "think_s", "prompt_len", "output_len",
            "strata", "first_output_len")


@dataclasses.dataclass(frozen=True)
class Request:
    index: int              # order of submission, over all clients
    client: int
    prompt: np.ndarray      # int32 token ids
    max_new: int


def strata(lo: int, hi: int, n: int) -> np.ndarray:
    """The mid-points of ``n`` equal slices of the integers ``lo..hi``."""
    span = hi - lo + 1
    return lo + np.floor(span * (np.arange(n) + 0.5) / n).astype(np.int64)


def check(traffic: Dict) -> None:
    missing = [k for k in REQUIRED if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    if traffic["loop"] != "closed" or traffic["think_s"] != 0:
        raise ValueError(f"only closed loops with no think time are "
                         f"generated, got {traffic['loop']!r}, think_s "
                         f"{traffic['think_s']!r}")
    for key in ("prompt_len", "output_len", "first_output_len"):
        lo, hi = traffic[key]
        if not 1 <= lo <= hi:
            raise ValueError(f"{key} must be 1 <= lo <= hi, got {lo, hi}")


def max_len(traffic: Dict) -> int:
    """Positions a request can fill: its prompt and every token but the
    last fed back."""
    return traffic["prompt_len"][1] + max(traffic["output_len"][1],
                                          traffic["first_output_len"][1]) - 1


def prompt_lengths(traffic: Dict) -> List[int]:
    """Every prompt length the traffic sends (the set, in order)."""
    lo, hi = traffic["prompt_len"]
    return sorted(set(int(v) for v in strata(lo, hi, traffic["strata"])))


class ClosedLoop:
    """The requests of a closed loop, in submission order, from the seed."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        check(traffic)
        self.vocab = int(vocab)
        self.clients = int(traffic["clients"])
        self.rng = np.random.default_rng(seed)
        n = int(traffic["strata"])
        self._p = strata(*traffic["prompt_len"], n)
        self._o = strata(*traffic["output_len"], n)
        self._order_p: List[np.ndarray] = []
        self._order_o: List[np.ndarray] = []
        first = strata(*traffic["first_output_len"], self.clients)
        self._first = first[self.rng.permutation(self.clients)]
        self.sent = 0

    def _sizes(self, k: int):
        n = len(self._p)
        block, i = divmod(k, n)
        while len(self._order_p) <= block:
            self._order_p.append(self.rng.permutation(n))
            self._order_o.append(self.rng.permutation(n))
        return (int(self._p[self._order_p[block][i]]),
                int(self._o[self._order_o[block][i]]))

    def next(self, client: int) -> Request:
        """The next request, sent by ``client``."""
        k = self.sent
        p_len, o_len = self._sizes(k)
        if k < self.clients:
            o_len = int(self._first[client])
        prompt = self.rng.integers(0, self.vocab, p_len).astype(np.int32)
        self.sent += 1
        return Request(index=k, client=client, prompt=prompt, max_new=o_len)

    def first(self) -> Sequence[Request]:
        """One request for each client, the first ones."""
        return [self.next(c) for c in range(self.clients)]
