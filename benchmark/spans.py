"""What the readers of the program's spans share. The program names the
phases of its train path with ``primia_tpu_torch.utils.span`` (the
train step's ``train.step``, ``train.augment``, ``train.mixup``,
``train.forward``, ``train.backward``, ``train.optimizer``, and the
loader's ``loader.batch``), and hands each span, as it closes under a
profiler, to ``utils.span_closed``: its name, host nanoseconds, CUDA
timing events at its two ends (None off CUDA) and the counters at its
close. A reader's ``PATCHES`` entry below notes those calls in the first
traced stretch, which records device activity alone; a program without
spans notes none, and the readers then read None.
"""

from __future__ import annotations

from statistics import fmean
from typing import Dict, List, Optional, Sequence, Tuple

STEP = "train.step"
LOADER = "loader.batch"


def note(calls, name, host_ns, start_event, end_event, counters):
    calls.append((name, host_ns, start_event, end_event, counters))


PATCHES = [("primia_tpu_torch.utils", "span_closed", note)]


def steps(calls) -> List[Dict[str, tuple]]:
    """The noted closes, a dict a step by span name: each step holds the
    closes from the last ``train.step`` close up to its own (its loader
    batch and its phases)."""
    out, cur = [], {}
    for c in calls:
        cur[c[0]] = c
        if c[0] == STEP:
            out.append(cur)
            cur = {}
    return out


def host_ms(calls, names: Sequence[str]) -> Optional[float]:
    """Mean host milliseconds a step of the spans ``names``."""
    per = steps(calls)
    if not per or any(n not in s for s in per for n in names):
        return None
    return fmean(sum(s[n][1] for n in names) for s in per) / 1e6


def stream_ms(calls, pairs: Sequence[Tuple[str, str]]) -> Optional[float]:
    """Mean stream milliseconds a step, summed over ``pairs``: for (a, b),
    from span a's start event to span b's end event. None off CUDA."""
    per = steps(calls)
    if not per or any(n not in s for s in per for p in pairs for n in p):
        return None
    if any(s[n][2] is None or s[n][3] is None for s in per for p in pairs for n in p):
        return None
    return fmean(sum(s[a][2].elapsed_time(s[b][3]) for a, b in pairs) for s in per)


def counter_per_step(calls, counter: str) -> Optional[float]:
    """The change of ``counter`` across each ``loader.batch`` and each
    ``train.step``, a step: each close's value less the last close's of
    either (the host runs nothing else between them), a mean for each of
    the two spans, summed. The stretch's first close has no earlier one
    and is left out."""
    tops = [(c[0], c[4][counter]) for c in calls if c[0] in (STEP, LOADER)
            and counter in c[4]]
    delta = {STEP: [], LOADER: []}
    for (_, before), (name, value) in zip(tops, tops[1:]):
        delta[name].append(value - before)
    if not delta[STEP] or not delta[LOADER]:
        return None
    return fmean(delta[STEP]) + fmean(delta[LOADER])
