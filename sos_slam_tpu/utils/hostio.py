"""Host<->device transfer discipline.

Every synchronous per-leaf device->host copy is a round trip of its own, and
`jax.device_get` on a pytree walks leaves sequentially, paying that cost per
leaf.

`fetch` starts a non-blocking `copy_to_host_async` on every leaf first (all
transfers in flight together, issued while the arrays are still hot), then
materializes.

Use `fetch` for every readback cluster; never call `np.asarray` /
`jax.device_get` directly on multiple device arrays in host control flow.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import jax

__all__ = ["fetch", "prefetch", "fetch_future"]


def prefetch(tree) -> None:
    """Start non-blocking device->host copies for every leaf.

    Call right after dispatching a program whose results are consumed a
    frame later: the transfers ride the execution completion, so the later
    `fetch` returns in ~0 instead of a full round trip."""
    for leaf in jax.tree.leaves(tree):
        if isinstance(leaf, jax.Array):
            try:
                leaf.copy_to_host_async()
            except Exception:
                pass


def fetch(tree):
    """device_get with all leaf transfers started asynchronously first."""
    prefetch(tree)
    return jax.device_get(tree)


# Several IO threads: each per-frame readback waits for its frame's
# program to finish, and a single worker would serialize those waits —
# capping the pipeline at one readback latency per frame no matter how
# fast the device runs. Round trips for different frames are independent
# (PJRT clients are thread-safe for concurrent transfers) and device_get
# releases the GIL while blocked, so 4 workers overlap them cleanly even
# on a small host. Completion order doesn't matter: every in-flight
# frame record holds its own Future.
_FETCH_WORKERS = 4
_fetch_pool: ThreadPoolExecutor | None = None


def fetch_future(tree) -> Future:
    """Start a `fetch` on a background IO thread and return its Future.

    A synchronous `device_get` blocks the host until the frame's program
    has run and its bytes have landed. Issuing the blocking `device_get`
    from a side thread right after dispatch overlaps that wait with the
    next frames' host work; by the time the pipeline consumes the result
    (two frames later) the transfer has long completed and `.result()`
    returns immediately.

    The worker only *reads* settled device arrays, so it is safe alongside
    the main thread's dispatches (PJRT clients are thread-safe for
    concurrent execute + transfer).

    NO completion-ordering guarantee: with several pool workers, futures
    submitted later may complete first. Callers must hold the Future for
    each readback they need (as the per-frame records do) — do not assume
    FIFO completion across calls."""
    global _fetch_pool
    if _fetch_pool is None:
        _fetch_pool = ThreadPoolExecutor(
            max_workers=_FETCH_WORKERS, thread_name_prefix="sos-fetch")
    prefetch(tree)
    return _fetch_pool.submit(jax.device_get, tree)
