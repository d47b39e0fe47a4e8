"""``repro_torch.serve`` — async stencil serving over the port's plans
(the reference's ``repro.serve``).

Admission -> coalesce -> padded ``run_batch``::

    from repro_torch.serve import StencilRequest, from_config

    service = await from_config({
        "buckets": [{"problem": {"stencil": "diffusion2d",
                                 "shape": [4096, 4096]},
                     "run": {"backend": "hopper", "par_time": 8,
                             "bsize": 256},
                     "max_batch": 8, "max_wait_ms": 2.0}],
    })
    out = await service.submit(StencilRequest("diffusion2d", grid, iters=50))
    print(service.snapshot()["latency_ms"])
    await service.stop()

Requests bucket by (stencil/program fingerprint, state shape, boundary
condition, dtype); each bucket coalesces compatible requests into one
``run_batch`` launch per super-step, padded along the batch axis to a
pre-warmed batch class; results are bit-identical to per-request
``plan().run()``.  A bucket's ``RunConfig(device=...)`` is ``"cuda"`` by
default; ``"cpu"`` serves through the kernels' plain versions.  Queues are
bounded: overload answers ``ServiceOverloaded`` with a retry-after hint.

Failure model: launches retry under a capped-exponential budget; a
still-failing coalesced launch is bisected so only the poison request(s)
fail (:class:`LaunchFailed`); delivered members pass a per-member
numerical health check that quarantines NaN/Inf/blowup members with
:class:`NumericalFault`; a per-bucket circuit breaker degrades a
persistently failing bucket to per-request launches, then to rejection.
"""
from repro_torch.serve.batcher import BucketState, PendingRequest
from repro_torch.serve.config import BucketConfig, ServiceConfig
from repro_torch.serve.metrics import ServiceMetrics, percentile
from repro_torch.serve.request import (DeadlineExceeded, LaunchFailed,
                                       NoMatchingBucket, NumericalFault,
                                       ServeError, ServeResult,
                                       ServiceClosed, ServiceOverloaded,
                                       StencilRequest, bucket_key)
from repro_torch.serve.service import (StencilService, coeffs_signature,
                                       from_config, serve)

__all__ = [
    "BucketConfig", "BucketState", "DeadlineExceeded", "LaunchFailed",
    "NoMatchingBucket", "NumericalFault", "PendingRequest", "ServeError",
    "ServeResult", "ServiceClosed", "ServiceConfig", "ServiceMetrics",
    "ServiceOverloaded", "StencilRequest", "StencilService", "bucket_key",
    "coeffs_signature", "from_config", "percentile", "serve",
]
