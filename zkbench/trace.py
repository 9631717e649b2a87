"""What a traced window leaves for the metric readers: the device's
operations from ``torch.profiler`` (CUPTI), their union, and the idle gaps
between them named by what the host was doing."""

from __future__ import annotations

import bisect
import collections

import torch

NAME_CHARS = 96
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::")  # dropped from names, so the functor shows


def short(name: str) -> str:
    for word in NOISE:
        name = name.replace(word, "")
    return name[:NAME_CHARS]


def events(prof) -> tuple[list, list]:
    """(device operations, host operations) as (name, start_ns, end_ns), each
    sorted by start; a span of the harness (``record_function``) is a host
    operation only."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        kind = e.device_type()
        annotation = e.is_user_annotation() if hasattr(e, "is_user_annotation") else e.name().startswith("zkbench.")
        if kind == torch.autograd.DeviceType.CUDA and not annotation:  # the harness's spans show on both timelines
            device.append((e.name(), start, end))
        elif kind == torch.autograd.DeviceType.CPU:
            host.append((e.name(), start, end))
    device.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return device, host


def merged(ops: list) -> list[tuple[int, int]]:
    """The union of the operations' intervals, as disjoint sorted intervals."""
    out: list[list[int]] = []
    for _, start, end in ops:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def by_name(ops: list, top: int = 10) -> list[list]:
    """Device seconds by operation name, most first."""
    total: dict[str, float] = collections.defaultdict(float)
    for name, start, end in ops:
        total[short(name)] += (end - start) / 1e9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_by_host(intervals: list[tuple[int, int]], host: list, top: int = 10) -> list[list]:
    """Idle seconds between device intervals, by the innermost host operation
    running at each gap's midpoint ("host, outside any op" where none was)."""
    gaps = sorted(((a[1] + b[0]) // 2, b[0] - a[1]) for a, b in zip(intervals, intervals[1:]) if b[0] > a[1])
    starts = [h[1] for h in host]
    total: dict[str, float] = collections.defaultdict(float)
    stack: list[tuple[int, str]] = []
    i = 0
    for mid, length in gaps:
        j = bisect.bisect_right(starts, mid)
        for name, start, end in host[i:j]:
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((end, name))
        i = max(i, j)
        while stack and stack[-1][0] < mid:
            stack.pop()
        total[short(stack[-1][1]) if stack else "host, outside any op"] += length / 1e9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
