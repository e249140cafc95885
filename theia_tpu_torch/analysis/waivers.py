"""Versioned waiver file for the static analysis passes.

Ports theia_tpu/analysis/waivers.py: the reference's waivers whose
findings exist at the port's paths (``theia_tpu_torch/...``), with the
invariant text unchanged. The one for the memory-stats probe the torch
``device_infos`` does not need is left out, since the gate fails a
waiver that matches nothing.

Every entry matches finding KEYS (``fnmatch`` glob against the stable
key, never line numbers) and MUST cite the invariant that makes the
flagged code safe — validation rejects a waiver whose ``invariant``
does not spell it out. A waiver that matches nothing is STALE and
fails the gate: the code it described has changed, so the file must
change with it.

Grammar:

    {"check": "<check name>",       # one of base.KNOWN_CHECKS
     "match": "<key glob>",         # fnmatch against Finding.key
     "invariant": "<why this specific code cannot deadlock/race/lose
                    the error — a reviewer should be able to FALSIFY
                    the sentence>"}

Waivers are reviewed like code: deleting the code a waiver covers
deletes the waiver (the stale check enforces it), and weakening an
invariant is a red flag in review.
"""

WAIVERS = [
    # -- blocking-under-lock ---------------------------------------------
    {
        "check": "blocking-under-lock",
        "match": "blocking-under-lock:theia_tpu_torch/store/wal.py:"
                 "wal.io:os.fsync",
        "invariant": (
            "The io lock IS the durability serialization point: "
            "fsync must cover exactly the bytes appended under the "
            "same lock hold, or a concurrent append could be "
            "acknowledged against an fsync that never covered it. "
            "Appends overlap their (dominant) body-checksum work "
            "OUTSIDE this lock by design; only the write+fsync tail "
            "serializes, and the sync policy bounds how often."),
    },
    # -- torn-read -------------------------------------------------------
    {
        "check": "torn-read",
        "match": "torn-read:theia_tpu_torch/cluster/node.py:ClusterNode:*",
        "invariant": (
            "Role transitions (promote/step_down) rebind each of "
            "role/term/leader/follower in single assignments under "
            "cluster.node. Every lock-free reader snapshots ONE "
            "attribute into a local, None-checks it, and tolerates "
            "staleness by protocol: a stale role answer yields a 307 "
            "redirect or ClusterStateError that the producer/peer "
            "retries, and step_down/promote re-validate role under "
            "the lock before acting. No reader dereferences a "
            "role-dependent attribute without its own None-check, so "
            "a torn (role, leader) pair cannot crash — it can only "
            "produce a retried refusal."),
    },
    {
        "check": "torn-read",
        "match": "torn-read:theia_tpu_torch/store/wal.py:WriteAheadLog:"
                 "_dirty_records,_last_sync_t",
        "invariant": (
            "_policy_sync's lock-free read is a double-checked "
            "throttle: it only decides whether to CALL sync(), and "
            "sync() re-reads _dirty_records under the io lock before "
            "doing anything. A torn read can at worst schedule one "
            "extra no-op sync or delay one interval-policy sync by "
            "one append — both inside the policy's documented loss "
            "bound."),
    },
    {
        "check": "torn-read",
        "match": "torn-read:theia_tpu_torch/store/wal.py:WriteAheadLog:"
                 "*synced_lsn*",
        "invariant": (
            "stats() is the /healthz monitoring surface: it reports "
            "point-in-time counters (last_lsn, synced_lsn, dirty "
            "counts) that are each written atomically (int rebinds "
            "under the io lock) and never fed back into control "
            "decisions. A scrape racing an append may see lsn N with "
            "synced N-1 for one render — monitoring staleness, not "
            "state corruption. The durability gate itself reads "
            "positions under the io lock via wal_position()."),
    },
    {
        "check": "torn-read",
        "match": "torn-read:theia_tpu_torch/store/wal.py:WriteAheadLog:"
                 "_dirty_bytes,_dirty_records,last_lsn",
        "invariant": (
            "Same stats()-surface read as the synced_lsn waiver: "
            "single-assignment ints rebound under the io lock, read "
            "lock-free only to render /healthz numbers; no control "
            "path consumes the racy pair."),
    },
    # -- swallowed-except ------------------------------------------------
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/cli/__main__.py:"
                 "_urlopen",
        "invariant": (
            "Parsing the error BODY of an already-failed HTTP "
            "request: the fallback keeps the raw body as the detail "
            "string, so no information is lost — the except only "
            "guards against non-JSON error bodies, and the original "
            "HTTPError is re-raised as the CLI error taxonomy "
            "either way."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/cli/__main__.py:main",
        "invariant": (
            "BrokenPipeError cleanup: stdout's consumer (`| head`) "
            "is gone; close() can itself raise EPIPE on the "
            "already-broken stream. The handler exists precisely to "
            "exit 0 quietly — there is nobody left to report to."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/cluster/node.py:"
                 "handle_resync",
        "invariant": (
            "Best-effort term extraction from an inbound resync "
            "payload while this node still believes it leads: on "
            "parse failure term stays 0 and the code path falls "
            "through to raising ClusterStateError — the sender "
            "retries after the heartbeat settles who leads. Failing "
            "to parse can only REFUSE a resync, never accept a bad "
            "one."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/cluster/replication.py:"
                 "stats",
        "invariant": (
            "Monitoring surface: wal_position() can raise while the "
            "store is resyncing/closed; stats() reports pos=0 for "
            "that render instead of failing /healthz. The durability "
            "gate reads the position through its own locked path."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/cluster/transport.py:"
                 "close",
        "invariant": (
            "Teardown of pooled keep-alive sockets: close() on an "
            "already-reset connection raises in some stdlib paths; "
            "every socket in the list must still get its close "
            "attempt (stopping at the first failure would leak the "
            "rest), and the process is shutting the transport down "
            "— there is no caller to surface the error to."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/ingest/client.py:"
                 "parse_retry_after",
        "invariant": (
            "Parsing an optional retryAfterSeconds field out of a "
            "429 body: on any parse failure the function falls "
            "through to the integer Retry-After header and then the "
            "documented 1s default — the contract is 'best hint "
            "available', and a malformed hint must not turn a "
            "retryable 429 into a client crash."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/manager/api.py:"
                 "refresh_scrape_gauges",
        "invariant": (
            "Scrape-time store gauges with every replica down: the "
            "gauges go stale for that render but the rest of the "
            "registry must stay scrapeable — /metrics serving "
            "through an outage is a PR-3 review-hardening "
            "requirement with its own regression test."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/obs/history.py:scrape",
        "invariant": (
            "refresh() re-evaluates scrape-time callback gauges "
            "before snapshotting the registry: a callback throwing "
            "(e.g. store momentarily closed) leaves that gauge's "
            "last value in the snapshot — stale scrape-time gauges "
            "beat a lost metrics-history tick, and the tick itself "
            "records counters/histograms regardless."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/query/engine.py:"
                 "table_fingerprints",
        "invariant": (
            "Fingerprinting every queryable table on a store that "
            "may predate one (an old snapshot without __metrics__): "
            "the absent table is omitted from the digest map, which "
            "is exactly the correct cache key for a store that "
            "cannot answer queries over it."),
    },
    {
        "check": "swallowed-except",
        "match": "swallowed-except:theia_tpu_torch/store/flow_store.py:"
                 "wal_tail_tagged_records",
        "invariant": (
            "The demoted-leader tail walk decodes each surviving WAL "
            "record to re-ingest it through the new leader; a record "
            "that fails to decode (torn/corrupt tail past the "
            "checksum horizon) is skipped so the REST of the tail "
            "still re-ingests — the skipped batch was by definition "
            "never acknowledged durable with a valid frame, and "
            "dedup makes the re-post idempotent either way."),
    },
    # -- raw-clock -------------------------------------------------------
    {
        "check": "raw-clock",
        "match": "raw-clock:theia_tpu_torch/store/wal.py:read:"
                 "time.monotonic",
        "invariant": (
            "The latch's lockdep-witness wait/hold measurement: it "
            "observes REAL wall contention for /debug/locks stats "
            "and is compiled out when THEIA_LOCKDEP is off. No test "
            "or control path consumes these durations; injecting a "
            "clock here would measure the injected clock, not the "
            "contention."),
    },
    {
        "check": "raw-clock",
        "match": "raw-clock:theia_tpu_torch/store/wal.py:write:"
                 "time.monotonic",
        "invariant": (
            "Same witness measurement as the read() waiver: "
            "observability-only wall-clock timing of real latch "
            "contention, active only under THEIA_LOCKDEP, never "
            "consumed by tests or control logic."),
    },
]
