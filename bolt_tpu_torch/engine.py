"""Process-wide counters of the port's host<->device traffic and of the
streaming executor.

Port of the accounting half of ``bolt_tpu/engine.py`` (``counters``,
``record_transfer``, ``record_codec``, ``record_stream``), under the
reference's counter names.  The program cache, donation and the rest of
the reference's engine have no user in the port yet.  Every update takes
one lock, so a snapshot never sees half of a record.
"""

import threading

_LOCK = threading.Lock()

_COUNTERS = {
    # host->device traffic (bolt_tpu_torch.stream: the counted transfer
    # and the uploader pool)
    "transfer_bytes": 0,       # host bytes shipped to the device
    "transfer_seconds": 0.0,   # seconds inside counted transfers, summed
    #                            across uploader workers
    # the streaming executor (bolt_tpu_torch.stream); overlap_seconds is
    # ingest time hidden behind compute: max(0, ingest + compute - wall)
    "stream_chunks": 0,             # slabs streamed
    "stream_ingest_seconds": 0.0,   # produce + encode + upload, summed
    #                                 across workers
    "stream_compute_seconds": 0.0,  # consumer dispatch + sync time
    "stream_wall_seconds": 0.0,     # end-to-end wall of streamed runs
    "stream_overlap_seconds": 0.0,  # ingest hidden behind compute
    "stream_prefetch_depth": 0,     # high-water configured prefetch depth
    "stream_upload_threads": 0,     # high-water concurrent uploaders
    "stream_inflight_high_water": 0,  # high-water slab programs
    #                                   dispatched but not yet confirmed
    # codec-encoded ingest (bolt_tpu_torch/gpu/codec.py): raw - wire =
    # host->device bytes saved; transfer_bytes tallies the wire bytes
    "codec_encode_seconds": 0.0,    # host seconds inside slab encodes
    "codec_bytes_raw": 0,           # pre-encode slab bytes
    "codec_bytes_wire": 0,          # post-encode slab bytes
}

_MAXIMA = ("stream_prefetch_depth", "stream_upload_threads",
           "stream_inflight_high_water")


def counters():
    """A snapshot of every counter, as a new dict."""
    with _LOCK:
        return dict(_COUNTERS)


def _update(**deltas):
    with _LOCK:
        for k, v in deltas.items():
            if k in _MAXIMA:
                _COUNTERS[k] = max(_COUNTERS[k], v)
            else:
                _COUNTERS[k] += v


def record_transfer(nbytes, seconds):
    """Tally one counted host->device transfer."""
    _update(transfer_bytes=int(nbytes), transfer_seconds=seconds)


def record_codec(raw_bytes, wire_bytes, seconds):
    """Tally one slab encode on an uploader worker."""
    _update(codec_bytes_raw=int(raw_bytes), codec_bytes_wire=int(wire_bytes),
            codec_encode_seconds=seconds)


def record_stream(chunks, ingest_s, compute_s, wall_s, overlap_s, depth,
                  uploaders=1, inflight=1):
    """Tally one completed streamed run; the depth, the run's concurrent
    uploader high-water and its in-flight high-water keep process
    maxima."""
    _update(stream_chunks=int(chunks), stream_ingest_seconds=ingest_s,
            stream_compute_seconds=compute_s, stream_wall_seconds=wall_s,
            stream_overlap_seconds=overlap_s,
            stream_prefetch_depth=int(depth),
            stream_upload_threads=int(uploaders),
            stream_inflight_high_water=int(inflight))
