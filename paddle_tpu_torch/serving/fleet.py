"""Fleet metrics federation: one pane of glass over K replicas.

The router scales serving out, and scatters the numbers with it: every
replica exports its own isolated ``/metrics``, so "what is the fleet's
occupancy" or "did scale-out dilute the prefix-cache hit rate" meant K
scrapes and a spreadsheet. :class:`FleetScraper` closes that gap on
the router, riding the health-poll cycle it already runs:

- each poll, every replica that exposes ``metrics_text()``
  (:class:`~paddle_tpu_torch.serving.replica.HTTPReplica` scrapes its debug
  server; :class:`LocalReplica` opts out — its series already live in
  the router's own registry) is scraped and parsed;
- the parsed series are RE-EXPORTED from the router's ``/metrics``
  under a ``fleet_`` name prefix with a ``replica`` label
  (``fleet_llm_ttft_seconds_bucket{replica="r0",le="0.05"}``) — the
  prefix keeps federated series from colliding with the same family
  names in the router process when a LocalReplica engine runs
  in-process;
- fleet-level AGGREGATES are computed into first-class gauges
  (``fleet_occupancy``, ``fleet_prefix_cache_hit_rate``,
  ``fleet_tokens_generated``, ``fleet_replicas_scraped``,
  ``fleet_mfu``, ``fleet_headroom_pages`` and
  ``fleet_goodput_fraction`` — the latter three with
  hole semantics: a down/warming replica or one without the series
  is ABSENT from the mean/sum, never a zero, with
  ``fleet_mfu_replicas``/``fleet_headroom_replicas``/
  ``fleet_goodput_replicas`` as auditable
  denominators) — the numbers device-resident decode and
  KV-page-migration routing need fleet-wide, not per-process;
- ``GET /fleetz`` (observability.server) renders the whole picture as
  JSON: per-replica health + breaker + key series next to the
  aggregates.

Stale data is marked, not hidden: a replica that stops answering keeps
its last snapshot with ``up: false`` and drops out of the aggregates,
so a dead replica reads as a hole, not as a zero.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..observability.metrics import MetricRegistry, default_registry

# sample-name suffixes that belong to a histogram family
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition (the 0.0.4 subset our own
    exporter emits) into ``{family_name: {"type": kind, "samples":
    [(sample_name, labels_dict, value)]}}``. Unparseable lines are
    skipped — a half-written scrape degrades to fewer series, never an
    exception on the poll thread."""
    families: Dict[str, dict] = {}
    last_family = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                families.setdefault(
                    parts[2], {"type": parts[3], "samples": []})
                last_family = parts[2]
            continue
        try:
            name_part, value_s = line.rsplit(" ", 1)
            value = float(value_s.replace("+Inf", "inf"))
        except ValueError:
            continue
        name, labels = _split_labels(name_part)
        if name is None:
            continue
        fam = _family_of(name, families, last_family)
        families.setdefault(fam, {"type": "untyped", "samples": []})
        families[fam]["samples"].append((name, labels, value))
    return families


def _split_labels(name_part: str) -> Tuple[Optional[str], Dict[str, str]]:
    if "{" not in name_part:
        return name_part.strip(), {}
    name, _, rest = name_part.partition("{")
    rest = rest.rstrip()
    if not rest.endswith("}"):
        return None, {}
    labels: Dict[str, str] = {}
    for pair in _split_label_pairs(rest[:-1]):
        k, _, v = pair.partition("=")
        if not k or len(v) < 2 or v[0] != '"' or v[-1] != '"':
            return None, {}
        labels[k] = v[1:-1]
    return name.strip(), labels


def _split_label_pairs(s: str) -> List[str]:
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    out, cur, in_q = [], [], False
    for ch in s:
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [p for p in (x.strip() for x in out) if p]


def _family_of(sample_name: str, families: dict, last_family) -> str:
    """Map a sample name back to its family: histogram samples carry
    _bucket/_sum/_count suffixes on the family name."""
    if sample_name in families:
        return sample_name
    for suf in _HIST_SUFFIXES:
        if sample_name.endswith(suf) and sample_name[:-len(suf)] \
                in families:
            return sample_name[:-len(suf)]
    # untyped stray sample: its own family (or the family whose TYPE
    # line immediately preceded it)
    if last_family and sample_name.startswith(last_family):
        return last_family
    return sample_name


def _series_value(fam: Optional[dict], sample_name: str) -> Optional[float]:
    if not fam:
        return None
    for name, _labels, value in fam["samples"]:
        if name == sample_name:
            return value
    return None


class FleetScraper:
    """Router-side federation of replica ``/metrics`` scrapes.

    Owns no thread: :meth:`scrape` is called from the router's health
    poller (one cycle, one scrape per replica), keeping fleet
    observability on exactly the cadence operators already reason
    about for health. ``federate_prefixes`` bounds what is re-exported
    (default: the ``llm_`` serving series + ``process``-level basics);
    aggregates always consider the full parse."""

    AGGREGATE_SOURCES = ("llm_batch_occupancy", "llm_kv_page_utilization",
                        "llm_prefix_cache_hit_tokens",
                        "llm_prompt_tokens", "llm_tokens_generated",
                        "llm_requests_completed", "perf_mfu",
                        "perf_flops_per_second", "mem_headroom_pages",
                        "goodput_fraction", "drift_verified_total",
                        "drift_divergence_total", "brownout_level")

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 federate_prefixes: Tuple[str, ...] = ("llm_", "perf_",
                                                       "mem_",
                                                       "badput_",
                                                       "kv_migrate_",
                                                       "drift_",
                                                       "brownout_",
                                                       "overload_"),
                 stale_after: float = 10.0):
        # NOTE: per-replica badput CAUSES federate
        # (fleet_badput_seconds_total{replica=,cause=}); the replica's
        # goodput_fraction gauge deliberately does NOT — its federated
        # name would collide with the fleet_goodput_fraction AGGREGATE
        # below. Per-replica fractions live on /fleetz instead.
        self.registry = registry or default_registry()
        self.federate_prefixes = tuple(federate_prefixes)
        self.stale_after = float(stale_after)
        self._mu = threading.Lock()
        # name -> {"ts": wall, "up": bool, "families": parse result}
        self._replicas: Dict[str, dict] = {}
        reg = self.registry
        self._g_scraped = reg.gauge(
            "fleet_replicas_scraped",
            "replicas whose /metrics answered the last scrape cycle")
        self._g_occ = reg.gauge(
            "fleet_occupancy",
            "mean decode-batch occupancy across scraped replicas "
            "(cumulative mean of llm_batch_occupancy per replica)")
        self._g_kv = reg.gauge(
            "fleet_kv_page_utilization",
            "mean KV-page-pool utilization across scraped replicas")
        self._g_hit = reg.gauge(
            "fleet_prefix_cache_hit_rate",
            "aggregate prefix-cache hit rate: sum(hit tokens) / "
            "sum(prompt tokens) across scraped replicas")
        self._g_tokens = reg.gauge(
            "fleet_tokens_generated",
            "tokens generated across scraped replicas (sum of the "
            "per-replica counters at last scrape)")
        self._g_completed = reg.gauge(
            "fleet_requests_completed",
            "requests completed across scraped replicas")
        self._g_up = reg.gauge(
            "fleet_replica_up",
            "1 when the replica's /metrics answered the last scrape",
            label_names=("replica",))
        self._g_mfu = reg.gauge(
            "fleet_mfu",
            "mean perf_mfu across UP replicas that export it — a down "
            "replica is a HOLE in the mean, never a zero (its capacity "
            "is gone, not idle); 0 with fleet_mfu_replicas=0 means no "
            "replica reports MFU yet")
        self._g_mfu_n = reg.gauge(
            "fleet_mfu_replicas",
            "replicas whose perf_mfu entered the fleet_mfu mean at the "
            "last scrape (the denominator that makes the hole "
            "semantics auditable)")
        self._g_fps = reg.gauge(
            "fleet_flops_per_second",
            "sum of perf_flops_per_second across scraped replicas")
        self._g_headroom = reg.gauge(
            "fleet_headroom_pages",
            "sum of mem_headroom_pages (KV pages each replica's paged "
            "pools could still hand out) across UP replicas that "
            "export it — a down or warming replica is a HOLE in the "
            "sum, never a zero (its capacity is gone, not exhausted). "
            "Per-replica values federate as "
            "fleet_mem_headroom_pages{replica=...} via the mem_ "
            "re-export prefix — the series KV-page-migration routing "
            "reads")
        self._g_headroom_n = reg.gauge(
            "fleet_headroom_replicas",
            "replicas whose mem_headroom_pages entered the "
            "fleet_headroom_pages sum at the last scrape (the "
            "auditable hole-semantics denominator, like "
            "fleet_mfu_replicas)")
        self._g_goodput = reg.gauge(
            "fleet_goodput_fraction",
            "mean goodput_fraction across UP replicas that export it "
            "— a down or never-armed (warming) replica is a HOLE in "
            "the mean, never a zero (its seconds are gone, not "
            "badput); 0 with fleet_goodput_replicas=0 means no "
            "replica has armed its time ledger yet")
        self._g_goodput_n = reg.gauge(
            "fleet_goodput_replicas",
            "replicas whose goodput_fraction entered the "
            "fleet_goodput_fraction mean at the last scrape (the "
            "auditable hole-semantics denominator, like "
            "fleet_mfu_replicas)")
        self._g_drift_ok = reg.gauge(
            "fleet_drift_verified",
            "stream-integrity checks that confirmed chain identity, "
            "summed across UP replicas that export drift_* — a down "
            "or never-armed replica is a HOLE in the sum, never a "
            "zero (its streams went unverified, not verified-clean); "
            "0 with fleet_drift_replicas=0 means no replica has "
            "armed its auditor yet")
        self._g_drift_bad = reg.gauge(
            "fleet_drift_divergences",
            "stream-integrity divergences summed across UP replicas "
            "that export drift_* (same hole semantics as "
            "fleet_drift_verified). ANY nonzero value is a fleet "
            "determinism incident — per-kind detail federates as "
            "fleet_drift_divergence_total{replica=,kind=}")
        self._g_drift_n = reg.gauge(
            "fleet_drift_replicas",
            "replicas whose drift_* counters entered the fleet_drift_"
            "sums at the last scrape (the auditable hole-semantics "
            "denominator, like fleet_mfu_replicas)")
        self._g_brownout = reg.gauge(
            "fleet_brownout_level",
            "MAX brownout_level across UP replicas that export it — "
            "the fleet is as degraded as its most-degraded member. A "
            "down or never-armed replica (no overload controller "
            "bound) is a HOLE, never a zero: 0 with "
            "fleet_brownout_replicas=0 means no replica runs a "
            "controller, not that the fleet is calm")
        self._g_brownout_n = reg.gauge(
            "fleet_brownout_replicas",
            "replicas whose brownout_level entered the "
            "fleet_brownout_level max at the last scrape (the "
            "auditable hole-semantics denominator, like "
            "fleet_mfu_replicas)")

    # -- ingestion ------------------------------------------------------
    @staticmethod
    def exports(client) -> bool:
        """True when the client is a metrics EXPORTER. Non-exporters
        (no ``metrics_text`` surface, or ``metrics_opt_out`` set —
        :class:`LocalReplica`'s same-process opt-out) stay absent from
        federation entirely: a healthy non-exporting replica must not
        read as a down one, so ``fleet_replica_up`` is only ever
        minted for exporters."""
        return getattr(client, "metrics_text", None) is not None \
            and not getattr(client, "metrics_opt_out", False)

    def scrape(self, name: str, client) -> bool:
        """Scrape one replica (called per health-poll cycle).
        Non-exporters (see :meth:`exports`) are forgotten, not marked
        down; an exporter whose scrape fails IS down (recorded via
        :meth:`record`, keeping its last snapshot out of the
        federated view)."""
        if not self.exports(client):
            self.forget(name)
            return False
        try:
            text = client.metrics_text()
        except Exception:  # noqa: BLE001 — a scrape failure is data
            text = None
        self.record(name, text)
        return text is not None

    def mark_unreachable(self, name: str, client) -> None:
        """The router's verdict for a replica whose HEALTH poll failed
        (no point timing out a second request on /metrics): exporters
        go down, non-exporters stay absent."""
        if self.exports(client):
            self.record(name, None)
        else:
            self.forget(name)

    def record(self, name: str, text: Optional[str]) -> None:
        if text is None:
            with self._mu:
                st = self._replicas.setdefault(
                    name, {"ts": 0.0, "up": False, "families": {}})
                st["up"] = False
            self._g_up.labels(name).set(0)
            self._refresh_aggregates()
            return
        families = parse_prometheus_text(text)
        with self._mu:
            self._replicas[name] = {"ts": time.time(), "up": True,
                                    "families": families}
        self._g_up.labels(name).set(1)
        self._refresh_aggregates()

    def forget(self, name: str) -> None:
        with self._mu:
            had = self._replicas.pop(name, None) is not None
        if had:
            # it WAS an exporter (detached, or re-pointed to a
            # non-exporting client): zero its liveness series rather
            # than leave a stale 1
            self._g_up.labels(name).set(0)
            self._refresh_aggregates()

    # -- aggregates -----------------------------------------------------
    def _snapshot_up(self) -> Dict[str, dict]:
        with self._mu:
            return {n: st for n, st in self._replicas.items()
                    if st["up"]}

    def _refresh_aggregates(self) -> dict:
        up = self._snapshot_up()
        occ, kv, mfu, headroom, goodput = [], [], [], [], []
        hit_tok = prompt_tok = tokens = completed = fps = 0.0
        drift_ok, drift_bad = [], []
        brownout = []
        for st in up.values():
            fams = st["families"]
            # perf federation: only replicas that EXPORT perf_mfu
            # enter the mean — a down replica (absent from `up`) or a
            # replica without the perf registry is a hole, not a zero
            m = _series_value(fams.get("perf_mfu"), "perf_mfu")
            if m is not None:
                mfu.append(m)
            # memory federation, same hole semantics: a replica whose
            # pool closed (or never opened — warming) exports no
            # mem_headroom_pages family at all and stays OUT of the
            # sum and its denominator
            hp = _series_value(fams.get("mem_headroom_pages"),
                               "mem_headroom_pages")
            if hp is not None:
                headroom.append(hp)
            # goodput federation, same hole semantics: a replica that
            # never armed its time ledger exports no goodput_fraction
            # family at all and stays OUT of the mean and denominator
            gp = _series_value(fams.get("goodput_fraction"),
                               "goodput_fraction")
            if gp is not None:
                goodput.append(gp)
            # drift federation, same hole semantics: a replica that
            # never armed its stream auditor (the counters mint at
            # FIRST record) exports no drift_* family at all and
            # stays out of both sums and the denominator — an
            # unverified fleet must read as unverified, not clean.
            # drift_divergence_total is {kind}-labeled: sum every
            # sample of the family, not just the first.
            # brownout federation, same hole semantics: a replica with
            # no overload controller bound exports no brownout_level
            # family at all and stays OUT of the max and denominator —
            # a fleet nobody governs must read as ungoverned, not calm
            bl = _series_value(fams.get("brownout_level"),
                               "brownout_level")
            if bl is not None:
                brownout.append(bl)
            dv = _series_value(fams.get("drift_verified_total"),
                               "drift_verified_total")
            if dv is not None:
                drift_ok.append(dv)
                bad_fam = fams.get("drift_divergence_total")
                drift_bad.append(sum(
                    value for _n, _l, value
                    in (bad_fam["samples"] if bad_fam else [])))
            fps += _series_value(fams.get("perf_flops_per_second"),
                                 "perf_flops_per_second") or 0.0
            o_sum = _series_value(fams.get("llm_batch_occupancy"),
                                  "llm_batch_occupancy_sum")
            o_cnt = _series_value(fams.get("llm_batch_occupancy"),
                                  "llm_batch_occupancy_count")
            if o_sum is not None and o_cnt:
                occ.append(o_sum / o_cnt)
            u = _series_value(fams.get("llm_kv_page_utilization"),
                              "llm_kv_page_utilization")
            if u is not None:
                kv.append(u)
            hit_tok += _series_value(
                fams.get("llm_prefix_cache_hit_tokens"),
                "llm_prefix_cache_hit_tokens") or 0.0
            prompt_tok += _series_value(
                fams.get("llm_prompt_tokens"), "llm_prompt_tokens") \
                or 0.0
            tokens += _series_value(
                fams.get("llm_tokens_generated"),
                "llm_tokens_generated") or 0.0
            completed += _series_value(
                fams.get("llm_requests_completed"),
                "llm_requests_completed") or 0.0
        agg = {
            "replicas_scraped": len(up),
            "occupancy": sum(occ) / len(occ) if occ else 0.0,
            "kv_page_utilization": sum(kv) / len(kv) if kv else 0.0,
            "prefix_cache_hit_rate": (hit_tok / prompt_tok
                                      if prompt_tok else 0.0),
            "tokens_generated": tokens,
            "requests_completed": completed,
            "mfu": (sum(mfu) / len(mfu)) if mfu else None,
            "mfu_replicas": len(mfu),
            "flops_per_second": fps,
            "mem_headroom_pages": sum(headroom) if headroom else None,
            "mem_headroom_replicas": len(headroom),
            "goodput_fraction": (sum(goodput) / len(goodput))
            if goodput else None,
            "goodput_replicas": len(goodput),
            "drift_verified": sum(drift_ok) if drift_ok else None,
            "drift_divergences": sum(drift_bad) if drift_ok else None,
            "drift_replicas": len(drift_ok),
            "brownout_level": max(brownout) if brownout else None,
            "brownout_replicas": len(brownout),
        }
        self._g_scraped.set(agg["replicas_scraped"])
        self._g_occ.set(agg["occupancy"])
        self._g_kv.set(agg["kv_page_utilization"])
        self._g_hit.set(agg["prefix_cache_hit_rate"])
        self._g_tokens.set(agg["tokens_generated"])
        self._g_completed.set(agg["requests_completed"])
        self._g_mfu.set(agg["mfu"] or 0.0)
        self._g_mfu_n.set(agg["mfu_replicas"])
        self._g_fps.set(agg["flops_per_second"])
        self._g_headroom.set(agg["mem_headroom_pages"] or 0.0)
        self._g_headroom_n.set(agg["mem_headroom_replicas"])
        self._g_goodput.set(agg["goodput_fraction"] or 0.0)
        self._g_goodput_n.set(agg["goodput_replicas"])
        self._g_drift_ok.set(agg["drift_verified"] or 0.0)
        self._g_drift_bad.set(agg["drift_divergences"] or 0.0)
        self._g_drift_n.set(agg["drift_replicas"])
        self._g_brownout.set(agg["brownout_level"] or 0.0)
        self._g_brownout_n.set(agg["brownout_replicas"])
        return agg

    def aggregates(self) -> dict:
        return self._refresh_aggregates()

    # -- re-export ------------------------------------------------------
    def render_prometheus(self) -> str:
        """The federated block appended to the router's /metrics:
        every matching replica series re-exported as
        ``fleet_<name>{replica="...",...}``."""
        up = self._snapshot_up()
        lines: List[str] = []
        typed = set()
        for rname in sorted(up):
            for fam_name, fam in sorted(up[rname]["families"].items()):
                if not fam_name.startswith(self.federate_prefixes):
                    continue
                if fam_name not in typed and fam["type"] != "untyped":
                    lines.append(
                        f"# TYPE fleet_{fam_name} {fam['type']}")
                    typed.add(fam_name)
                for sname, labels, value in fam["samples"]:
                    merged = {"replica": rname, **labels}
                    inner = ",".join(f'{k}="{v}"'
                                     for k, v in merged.items())
                    v = "+Inf" if value == float("inf") else repr(value)
                    lines.append(f"fleet_{sname}{{{inner}}} {v}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- /fleetz --------------------------------------------------------
    def replica_report(self) -> Dict[str, dict]:
        """Per-replica digest for /fleetz: liveness + the headline
        serving series (full detail stays on the replica's own
        /metrics, federated under fleet_*)."""
        with self._mu:
            snap = {n: dict(st) for n, st in self._replicas.items()}
        out: Dict[str, dict] = {}
        now = time.time()
        for name, st in snap.items():
            fams = st["families"]
            o_sum = _series_value(fams.get("llm_batch_occupancy"),
                                  "llm_batch_occupancy_sum")
            o_cnt = _series_value(fams.get("llm_batch_occupancy"),
                                  "llm_batch_occupancy_count")
            out[name] = {
                "up": st["up"],
                "scrape_age_s": (round(now - st["ts"], 3)
                                 if st["ts"] else None),
                "stale": bool(st["ts"]
                              and now - st["ts"] > self.stale_after),
                "occupancy": (round(o_sum / o_cnt, 4)
                              if o_sum is not None and o_cnt else None),
                "kv_page_utilization": _series_value(
                    fams.get("llm_kv_page_utilization"),
                    "llm_kv_page_utilization"),
                "prefix_cache_hit_rate": _series_value(
                    fams.get("llm_prefix_cache_hit_rate"),
                    "llm_prefix_cache_hit_rate"),
                "tokens_generated": _series_value(
                    fams.get("llm_tokens_generated"),
                    "llm_tokens_generated"),
                "requests_completed": _series_value(
                    fams.get("llm_requests_completed"),
                    "llm_requests_completed"),
                "mfu": _series_value(fams.get("perf_mfu"), "perf_mfu"),
                "mem_headroom_pages": _series_value(
                    fams.get("mem_headroom_pages"),
                    "mem_headroom_pages"),
                "goodput_fraction": _series_value(
                    fams.get("goodput_fraction"), "goodput_fraction"),
            }
        return out
