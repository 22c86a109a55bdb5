"""Cells of the benchmark cut to a size the CPU runs in seconds: 32 px
images, a batch of 4 (train) or 1-2 images a request, a pool of a few
batches. Everything else is the cell's own file."""

from __future__ import annotations

import copy

from benchmark import common


# cells whose harness is built and whose program is at fault (PERF.md, Open
# questions): kept out of BENCHMARK.json, held here to their files
PENDING = {"resnet18.encrypted_fss": ("resnet18", "encrypted_fss_b4"),
           "vgg16.encrypted_fss": ("vgg16", "encrypted_fss_b1")}


def small_cell(workload: str, res: int = 32, batch: int = 4, per: int = 1):
    entry, cfg, traffic, limits = common.cell(workload, *PENDING.get(workload, ()))
    cfg, traffic = copy.deepcopy(cfg), dict(traffic)
    cfg["args"].update(train_resolution=res, inference_resolution=res, batch_size=batch)
    cfg["architecture"]["resolution"] = res
    cfg["assumed"]["pool_images"] = 4 * batch
    traffic.update(pool_images=8, images_per_request=per, settle_images=8,
                   warmup_requests=0, trace_requests=1, warmup_steps=1, trace_steps=1,
                   reference_block=4)
    return entry, cfg, traffic, limits
