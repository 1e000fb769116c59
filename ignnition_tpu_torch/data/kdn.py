"""Reader + migration for the raw KDN "datasets_v0" simulator datasets
(NSFNET / GEANT2 / synth50 — the datasets the reference framework trains on,
readme.md:36-44).

Raw layout (reference examples/Routenet/datanetAPI.py describes the same
format): a dataset root contains `graph_attr.txt` (GML topology whose edges
carry `port` and `bandwidth` attributes) plus many `*.tar.gz` archives, each
holding one directory with

  * Routing.txt            — per-source lines of egress ports per destination
  * simulationResults.txt  — one simulation sample per line: 10*N*N comma-
                             separated fields = N*N (AvgBw, PktsGen, PktsDrop)
                             triples followed by N*N (AvgDelay, p10, p20, p50,
                             p80, p90, Jitter) septuples, row-major by
                             (src, dst)
  * params.ini             — simulationDuration and the max average lambda

This implementation parses result lines vectorized (numpy reshape instead of
the reference's quadruple python loop) and exposes plain-array samples.

`migrate()` converts to the framework's JSON graph format: one `link` entity
per topology edge, one `path` entity per ordered (src, dst) pair, adjacency
dicts from the routing paths, features traffic/delay/jitter/link_capacity —
the same output contract as the reference migration CLI
(examples/Routenet/migrate.py:54-156).
"""

from __future__ import annotations

import json
import os
import random
import tarfile
from dataclasses import dataclass
from enum import IntEnum
from io import BytesIO
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class TimeDist(IntEnum):
    """Packet inter-arrival time distributions (reference datanetAPI.py:24-50;
    datasets_v0 only ever carries EXPONENTIAL_T)."""

    EXPONENTIAL_T = 0
    DETERMINISTIC_T = 1
    UNIFORM_T = 2
    NORMAL_T = 3
    ONOFF_T = 4
    PPBP_T = 5

    @staticmethod
    def getStrig(timeDist) -> str:
        """Name for a distribution code; "UNKNOWN" for out-of-range values
        (reference datanetAPI.py:35-49 — the reference spells it `getStrig`,
        kept verbatim for drop-in API parity)."""
        try:
            return TimeDist(timeDist).name
        except ValueError:
            return "UNKNOWN"


class SizeDist(IntEnum):
    """Packet size distributions (reference datanetAPI.py:52-72; datasets_v0
    only ever carries BINOMIAL_S)."""

    DETERMINISTIC_S = 0
    UNIFORM_S = 1
    BINOMIAL_S = 2
    GENERIC_S = 3

    @staticmethod
    def getStrig(sizeDist) -> str:
        """Name for a distribution code; "UNKNOWN" for out-of-range values
        (reference datanetAPI.py:61-72, same `getStrig` spelling)."""
        try:
            return SizeDist(sizeDist).name
        except ValueError:
            return "UNKNOWN"


@dataclass
class KdnSample:
    """One simulation sample: matrices indexed [src, dst]."""

    topology: "object"  # networkx multigraph
    routing: np.ndarray  # [N, N] object array of node paths
    traffic_bps: np.ndarray  # [N, N] average bandwidth (bps)
    pkts_gen: np.ndarray  # [N, N]
    pkts_drop: np.ndarray  # [N, N]
    delay: np.ndarray  # [N, N] average per-packet delay
    delay_percentiles: np.ndarray  # [N, N, 5] p10/p20/p50/p80/p90
    jitter: np.ndarray  # [N, N]
    max_avg_lambda: float
    simulation_time: float
    # per-flow matrices from flowSimulationResults.txt when present
    # (reference datanetAPI.py:721-833); None -> the aggregate IS the single
    # flow, exactly the reference's `f = r` fallback
    flow_traffic: Optional[np.ndarray] = None  # [N, N, F, 3] (AvgBw kbps, PktsGen, PktsDrop)
    flow_perf: Optional[np.ndarray] = None  # [N, N, F, 7] (AvgDelay, p10..p90, Jitter)

    @property
    def n_nodes(self) -> int:
        return self.traffic_bps.shape[0]

    @property
    def num_flows(self) -> int:
        return 1 if self.flow_traffic is None else self.flow_traffic.shape[2]

    # -- accessor parity with the reference datanetAPI Sample --------------
    # (datanetAPI.py:152-313; matrices here are plain arrays, the per-pair
    # getters return the same quantities)

    def get_network_size(self) -> int:
        return self.n_nodes

    def get_topology_object(self):
        return self.topology

    def get_routing_matrix(self) -> np.ndarray:
        return self.routing

    def get_srcdst_routing(self, src: int, dst: int):
        return self.routing[src, dst]

    def _flow_triples(self, src: int, dst: int) -> np.ndarray:
        """[F, 3] (AvgBw kbps, TotalPktsGen, PktsDrop) — the aggregate triple
        doubles as the single flow when no flow file exists (the reference's
        `f = r` fallback, datanetAPI.py:741-744)."""
        if self.flow_traffic is not None:
            return self.flow_traffic[src, dst]
        return np.array(
            [[self.traffic_bps[src, dst] / 1000.0,
              self.pkts_gen[src, dst], self.pkts_drop[src, dst]]]
        )

    def _flow_septuples(self, src: int, dst: int) -> np.ndarray:
        """[F, 7] (AvgDelay, p10, p20, p50, p80, p90, Jitter)."""
        if self.flow_perf is not None:
            return self.flow_perf[src, dst]
        return np.concatenate(
            [[self.delay[src, dst]], self.delay_percentiles[src, dst],
             [self.jitter[src, dst]]]
        ).reshape(1, 7)

    def get_srcdst_traffic(self, src: int, dst: int) -> Dict[str, object]:
        flows = []
        for bw_kbps, gen, _drop in self._flow_triples(src, dst):
            bw = float(bw_kbps) * 1000.0
            flows.append(
                {
                    "AvgBw": bw,
                    "PktsGen": float(np.round(gen / self.simulation_time, 6)),
                    "TotalPktsGen": float(gen),
                    "ToS": 0,
                    # datasets_v0 traffic models (datanetAPI.py:835-874)
                    "TimeDist": TimeDist.EXPONENTIAL_T,
                    "TimeDistParams": {
                        "EqLambda": bw,
                        "AvgPktsLambda": bw / 1000.0,  # avg pkt size 1000
                        "ExpMaxFactor": 10,
                    },
                    "SizeDist": SizeDist.BINOMIAL_S,
                    "SizeDistParams": {
                        "AvgPktSize": 1000,
                        "PktSize1": 300,
                        "PktSize2": 1700,
                    },
                }
            )
        return {
            "AggInfo": {
                "AvgBw": float(self.traffic_bps[src, dst]),
                "PktsGen": float(self.pkts_gen[src, dst] / self.simulation_time),
                "TotalPktsGen": float(self.pkts_gen[src, dst]),
            },
            "Flows": flows,
        }

    def get_srcdst_performance(self, src: int, dst: int) -> Dict[str, object]:
        flows = []
        for row in self._flow_septuples(src, dst):
            flows.append(
                {
                    "AvgDelay": float(row[0]),
                    **{f"p{p}": float(row[1 + i])
                       for i, p in enumerate((10, 20, 50, 80, 90))},
                    "Jitter": float(row[6]),
                }
            )
        # per-flow drops ride the traffic triple (reference dict_result_tmp
        # takes PktsDrop from the flow TRAFFIC fields, datanetAPI.py:838-841)
        for d, (_bw, _gen, drop) in zip(flows, self._flow_triples(src, dst)):
            d["PktsDrop"] = float(np.round(drop / self.simulation_time, 6))
        return {
            "AggInfo": {
                "AvgDelay": float(self.delay[src, dst]),
                "Jitter": float(self.jitter[src, dst]),
                "PktsDrop": float(self.pkts_drop[src, dst] / self.simulation_time),
                **{
                    f"p{p}": float(self.delay_percentiles[src, dst, i])
                    for i, p in enumerate((10, 20, 50, 80, 90))
                },
            },
            "Flows": flows,
        }

    def get_traffic_matrix(self) -> np.ndarray:
        """[N, N] object matrix of per-pair traffic dicts (reference
        datanetAPI.py:178-183; a plain object ndarray here instead of the
        reference's np.matrix — same [i, j] indexing, same cell dicts,
        diagonal included as the reference fills it)."""
        if getattr(self, "_traffic_matrix", None) is None:
            n = self.n_nodes
            m = np.empty((n, n), dtype=object)
            for i in range(n):
                for j in range(n):
                    m[i, j] = self.get_srcdst_traffic(i, j)
            self._traffic_matrix = m
        return self._traffic_matrix

    def get_performance_matrix(self) -> np.ndarray:
        """[N, N] object matrix of per-pair performance dicts (reference
        datanetAPI.py:152-157)."""
        if getattr(self, "_performance_matrix", None) is None:
            n = self.n_nodes
            m = np.empty((n, n), dtype=object)
            for i in range(n):
                for j in range(n):
                    m[i, j] = self.get_srcdst_performance(i, j)
            self._performance_matrix = m
        return self._performance_matrix

    def get_node_properties(self, node_id: int) -> Optional[Dict[str, object]]:
        """Attribute dict of topology node `node_id`, or None when the node
        does not exist (reference datanetAPI.py:244-263)."""
        if node_id in self.topology.nodes:
            return self.topology.nodes[node_id]
        return None

    def get_link_properties(self, src: int, dst: int) -> Optional[Dict[str, object]]:
        """Attribute dict of the (first) topology edge src->dst, or None when
        no such link exists (reference datanetAPI.py:266-289)."""
        if src in self.topology and dst in self.topology[src]:
            return self.topology[src][dst][0]
        return None

    def get_srcdst_link_bandwidth(self, src: int, dst: int) -> float:
        g = self.topology
        if dst in g[src]:
            return float(g[src][dst][0]["bandwidth"])
        return -1.0

    def get_maxAvgLambda(self) -> float:
        return self.max_avg_lambda

    def get_global_delay(self) -> float:
        return self.global_stats()["avg_delay"]

    def get_global_packets(self) -> float:
        return self.global_stats()["packets_per_sec"]

    def get_global_losses(self) -> float:
        return self.global_stats()["losses_per_sec"]

    def global_stats(self) -> Dict[str, float]:
        n = self.n_nodes
        off = ~np.eye(n, dtype=bool)
        return {
            "packets_per_sec": float(self.pkts_gen[off].sum() / self.simulation_time),
            "losses_per_sec": float(self.pkts_drop[off].sum() / self.simulation_time),
            "avg_delay": float(self.delay[off].mean()),
        }


# --------------------------------------------------------------------------
# topology / routing
# --------------------------------------------------------------------------


def load_topology(path: str):
    import networkx as nx

    g = nx.read_gml(path, destringizer=int)
    for u, v, key in g.edges(keys=True):
        bw = g[u][v][key].get("bandwidth")
        if isinstance(bw, str):
            g[u][v][key]["bandwidth"] = bw.replace("kbps", "000")
    return g


def _port_to_next_node(g) -> Dict[int, Dict[int, int]]:
    """node -> egress port -> neighbor, from the GML 'port' edge attribute."""
    table: Dict[int, Dict[int, int]] = {}
    for node in g:
        table[node] = {}
        for neigh in g[node]:
            table[node][g[node][neigh][0]["port"]] = neigh
    return table


def parse_routing(text: str, g) -> np.ndarray:
    """Routing.txt -> [N, N] object matrix of node paths (src..dst)."""
    n = g.number_of_nodes()
    ports = np.full((n, n), -1, dtype=np.int64)
    for src, line in enumerate(l for l in text.splitlines() if l.strip()):
        fields = [f for f in line.split(",") if f.strip() != ""]
        ports[src, : len(fields)] = [int(float(f)) for f in fields]
    nxt = _port_to_next_node(g)
    paths = np.empty((n, n), dtype=object)
    for src in range(n):
        for dst in range(n):
            node, path = src, [src]
            while ports[node, dst] != -1:
                node = nxt[node][int(ports[node, dst])]
                path.append(node)
                if len(path) > n:  # defensive: malformed routing loop
                    break
            paths[src, dst] = path
    return paths


# --------------------------------------------------------------------------
# results lines
# --------------------------------------------------------------------------


def _line_fields(line: str) -> np.ndarray:
    return np.array(
        [float(f) for f in line.strip().rstrip(";").split(",") if f.strip() != ""],
        dtype=np.float64,
    )


def parse_results_line(
    line: str,
    topology,
    routing,
    sim_time: float,
    max_avg_lambda: float,
    flow_line: Optional[str] = None,
) -> KdnSample:
    fields = _line_fields(line)
    n2 = fields.size // 10
    n = int(round(np.sqrt(n2)))
    if n * n * 10 != fields.size:
        raise ValueError(
            f"malformed results line: {fields.size} fields is not 10*N^2"
        )
    traffic = fields[: 3 * n2].reshape(n, n, 3)
    perf = fields[3 * n2 :].reshape(n, n, 7)
    flow_traffic = flow_perf = None
    if flow_line is not None and flow_line.strip():
        # flowSimulationResults.txt: N*N*F (AvgBw, PktsGen, PktsDrop) triples
        # then N*N*F 7-field perf, flow-major within each (src, dst)
        # (reference datanetAPI.py:748-846: offsets
        # (src*N*F + dst*F + flow)*3 and N*N*F*3 + (...)*7)
        ff = _line_fields(flow_line)
        nf = ff.size // (n * n * 10)
        if n * n * nf * 10 != ff.size:
            raise ValueError(
                f"malformed flow results line: {ff.size} fields is not "
                f"10*N^2*F (N={n})"
            )
        flow_traffic = ff[: 3 * n2 * nf].reshape(n, n, nf, 3)
        flow_perf = ff[3 * n2 * nf :].reshape(n, n, nf, 7)
    return KdnSample(
        topology=topology,
        routing=routing,
        traffic_bps=traffic[:, :, 0] * 1000.0,  # kbps -> bps
        pkts_gen=traffic[:, :, 1],
        pkts_drop=traffic[:, :, 2],
        delay=perf[:, :, 0],
        delay_percentiles=perf[:, :, 1:6],
        jitter=perf[:, :, 6],
        max_avg_lambda=max_avg_lambda,
        simulation_time=sim_time,
        flow_traffic=flow_traffic,
        flow_perf=flow_perf,
    )


def _parse_params(text: str) -> Tuple[float, float]:
    sim_time, max_lambda = 1.0, 0.0
    for line in text.splitlines():
        if "simulationDuration" in line and "=" in line:
            sim_time = float(line.split("=", 1)[1])
        elif "lambda" in line and "=" in line:
            max_lambda = float(line.split("=", 1)[1])
    return sim_time, max_lambda


# --------------------------------------------------------------------------
# dataset iteration
# --------------------------------------------------------------------------


def iter_kdn_samples(
    data_folder: str,
    intensity_range: Optional[Tuple[int, int]] = None,
    shuffle_archives: bool = False,
    seed: Optional[int] = None,
) -> Iterator[KdnSample]:
    """Walk a raw dataset root and yield samples.

    intensity_range: keep only archives whose file name encodes an intensity
    inside [lo, hi] (file names look like `results_<topo>_<lo>-<hi>_....tar.gz`).
    """
    rng = random.Random(seed)
    for root, _dirs, files in os.walk(data_folder):
        if "graph_attr.txt" not in files:
            continue
        g = load_topology(os.path.join(root, "graph_attr.txt"))
        archives = sorted(f for f in files if f.endswith("tar.gz"))
        if shuffle_archives:
            rng.shuffle(archives)
        for fname in archives:
            if intensity_range is not None and not _intensity_ok(
                fname, intensity_range
            ):
                continue
            with tarfile.open(os.path.join(root, fname), "r:gz") as tar:
                # member names may carry a './' prefix (tar -czf ./dir) and
                # an empty archive has no members (the first
                # member's raw prefix silently made every read miss, and
                # tar.next() could be None) — index normalized names once
                # strip only a literal './' prefix — lstrip("./") would eat
                # ALL leading '.'/'/' chars and over-strip names like
                # '.hidden' or '../dir'
                member_names = {
                    (n[2:] if n.startswith("./") else n): n
                    for n in tar.getnames()
                }
                bases = {
                    n.split("/")[0] for n in member_names if "/" in n
                }
                if not member_names:
                    continue
                base = sorted(bases)[0] if bases else ""

                def read(name):
                    key = f"{base}/{name}" if base else name
                    real = member_names.get(key)
                    if real is None:
                        return ""  # optional member (flowSimulationResults)
                    member = tar.extractfile(real)
                    return member.read().decode() if member else ""

                sim_time, max_lambda = _parse_params(read("params.ini"))
                routing = parse_routing(read("Routing.txt"), g)
                # per-flow results pair with aggregate lines 1:1 when present
                flow_lines = read("flowSimulationResults.txt").splitlines()
                for i, line in enumerate(
                    read("simulationResults.txt").splitlines()
                ):
                    if not line.strip():
                        continue
                    fl = flow_lines[i] if i < len(flow_lines) else None
                    yield parse_results_line(
                        line, g, routing, sim_time, max_lambda, flow_line=fl
                    )


def _intensity_ok(fname: str, want: Tuple[int, int]) -> bool:
    try:
        token = fname.split("_")[2]
        vals = [int(v) for v in token.split("-")]
    except (IndexError, ValueError):
        return True
    lo, hi = vals[0], vals[-1]
    return not (lo > want[1] or hi < want[0])


# --------------------------------------------------------------------------
# migration to framework JSON
# --------------------------------------------------------------------------


def sample_to_graph_json(sample: KdnSample) -> dict:
    """One KdnSample -> the framework's JSON graph dict (same contract as
    reference migrate.process_sample)."""
    g = sample.topology
    n = sample.n_nodes

    entities: Dict[str, str] = {}
    link_by_edge: Dict[Tuple[int, int], str] = {}
    link_capacity: List[float] = []
    for idx, (u, v, k) in enumerate(g.edges(keys=True)):
        name = f"l{idx}"
        entities[name] = "link"
        # parallel links: each entity carries ITS OWN edge's bandwidth
        # (never key-0's copied onto every parallel link) and
        # routing maps the node pair to the FIRST parallel link,
        # deterministically (routes name node pairs, not edge keys)
        link_by_edge.setdefault((u, v), name)
        link_capacity.append(float(g[u][v][k]["bandwidth"]))

    traffic: List[float] = []
    delay: List[float] = []
    jitter: List[float] = []
    adj_links_paths: Dict[str, List[str]] = {}
    adj_paths_links: Dict[str, List[str]] = {}

    path_idx = 0
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            pname = f"p{path_idx}"
            entities[pname] = "path"
            traffic.append(float(sample.traffic_bps[i, j]))
            delay.append(float(sample.delay[i, j]))
            jitter.append(float(sample.jitter[i, j]))
            nodes = sample.routing[i, j]
            for a, b in zip(nodes[:-1], nodes[1:]):
                lname = link_by_edge[(a, b)]
                adj_links_paths.setdefault(pname, []).append(lname)
                adj_paths_links.setdefault(lname, []).append(pname)
            path_idx += 1

    return {
        "entities": entities,
        "link_capacity": link_capacity,
        "traffic": traffic,
        "delay": delay,
        "jitter": jitter,
        "adj_links_paths": adj_links_paths,
        "adj_paths_links": adj_paths_links,
    }


class _ArchiveWriter:
    def __init__(self, directory: str, samples_per_archive: int):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.per_archive = samples_per_archive
        self.buffer: List[dict] = []
        self.counter = 0

    def add(self, item: dict):
        self.buffer.append(item)
        if len(self.buffer) >= self.per_archive:
            self.flush()

    def flush(self):
        if not self.buffer:
            return
        payload = json.dumps(self.buffer).encode()
        path = os.path.join(self.directory, f"sample_{self.counter}.tar.gz")
        with tarfile.open(path, "w:gz") as tar:
            info = tarfile.TarInfo("data.json")
            info.size = len(payload)
            tar.addfile(info, BytesIO(payload))
        self.counter += 1
        self.buffer = []


def migrate(
    dataset_dir: str,
    output_dir: str,
    samples_per_archive: int = 100,
    train_fraction: float = 0.8,
    seed: int = 0,
    limit: Optional[int] = None,
    intensity_range: Optional[Tuple[int, int]] = None,
) -> Tuple[int, int]:
    """Raw KDN dataset -> train/eval JSON archives (random split, matching
    the reference migration CLI's 80/20 behavior). Returns (n_train, n_eval)."""
    rng = random.Random(seed)
    train = _ArchiveWriter(os.path.join(output_dir, "train"), samples_per_archive)
    evalw = _ArchiveWriter(os.path.join(output_dir, "eval"), samples_per_archive)
    n_train = n_eval = 0
    for count, sample in enumerate(
        iter_kdn_samples(dataset_dir, intensity_range=intensity_range)
    ):
        if limit is not None and count >= limit:
            break
        item = sample_to_graph_json(sample)
        if rng.random() <= train_fraction:
            train.add(item)
            n_train += 1
        else:
            evalw.add(item)
            n_eval += 1
    train.flush()
    evalw.flush()
    return n_train, n_eval
