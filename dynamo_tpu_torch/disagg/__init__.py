"""Disaggregated prefill/decode serving: a port of ``dynamo_tpu.disagg``,
on the same wire.

* ``protocols``: RemotePrefillRequest and the disagg config schema.
* ``router``: conditional disaggregation, local vs remote prefill from the
  prompt's uncached length and the prefill queue's depth, with the config
  hot-reloaded from a control-plane store watch.
* ``queue``: the prefill work queue, with ack and redelivery.
* ``transfer``: the KV data plane. The prefill worker gathers the computed
  blocks on the card, ships them layer-chunked over a TCP stream (two-part
  codec frames) to the decode worker, which scatters them into its own
  paged cache; in one process, ``LocalKvPipe`` hands CUDA tensors over.
* ``worker``: PrefillWorker (the queue consumer) and DisaggEngine (the
  decode-side AsyncEngine that orchestrates remote prefill).

Left out (ROADMAP A.8): ``disagg/ici.py``, the same-slice negotiated
landing.
"""

from .protocols import DisaggConfig, RemotePrefillRequest, disagg_config_key
from .queue import PrefillQueue
from .router import ConditionalDisaggRouter
from .transfer import (
    KV_STREAM_VERSION,
    KvDelivery,
    KvStreamSender,
    KvTransferServer,
    LocalKvPipe,
    TransferError,
    send_kv_blocks,
)
from .worker import DisaggEngine, PrefillWorker

__all__ = [
    "ConditionalDisaggRouter",
    "DisaggConfig",
    "DisaggEngine",
    "KV_STREAM_VERSION",
    "KvDelivery",
    "KvStreamSender",
    "KvTransferServer",
    "LocalKvPipe",
    "PrefillQueue",
    "PrefillWorker",
    "RemotePrefillRequest",
    "TransferError",
    "disagg_config_key",
    "send_kv_blocks",
]
