"""Synthetic packet-trace generation (numpy copy of
``repro.traffic.generator``).

Traces are synthesised with the statistical shape of the published attack
descriptions (DESIGN.md §7).  The generators are copied verbatim in
behaviour, so the same seed gives the same trace in both packages; only
``to_torch`` is new.

Every generator returns a dict of numpy arrays (ts sorted ascending):
  ts f32 [s] · src u32 · dst u32 · sport u32 · dport u32 · proto u32 ·
  length f32 [bytes] · label u8 (1 = attack packet)
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Trace = Dict[str, np.ndarray]

_TCP, _UDP = 6, 17

# address space helpers (plain uint32 host ids)
_LAN = 0x0A000000          # 10.0.0.0/8
_WAN = 0xC0000000


def _merge(traces: List[Trace]) -> Trace:
    out = {k: np.concatenate([t[k] for t in traces]) for k in traces[0]}
    order = np.argsort(out["ts"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def _mk(ts, src, dst, sport, dport, proto, length, label) -> Trace:
    n = len(ts)
    b = lambda v, dt: np.broadcast_to(np.asarray(v, dt), (n,)).copy()
    return {
        "ts": np.asarray(ts, np.float32),
        "src": b(src, np.uint32), "dst": b(dst, np.uint32),
        "sport": b(sport, np.uint32), "dport": b(dport, np.uint32),
        "proto": b(proto, np.uint32),
        "length": np.asarray(length, np.float32),
        "label": b(label, np.uint8),
    }


# ---------------------------------------------------------------------------
# Benign background: web + dns + ntp + smtp flows, heavy-tailed sizes
# ---------------------------------------------------------------------------
def benign_trace(n_packets: int, duration: float, rng: np.random.Generator,
                 n_clients: int = 40, n_servers: int = 12) -> Trace:
    traces = []
    remaining = n_packets
    while remaining > 0:
        kind = rng.choice(["web", "dns", "ntp", "smtp"], p=[0.6, 0.25, 0.05, 0.1])
        client = _LAN + int(rng.integers(1, n_clients + 1))
        server = _WAN + int(rng.integers(1, n_servers + 1))
        t0 = rng.uniform(0, duration)
        if kind == "web":
            m = int(min(remaining, rng.pareto(1.5) * 8 + 4))
            gaps = rng.exponential(0.02, m)
            ts = t0 + np.cumsum(gaps)
            down = rng.random(m) < 0.65          # server->client heavy
            sizes = np.where(down, rng.normal(1200, 220, m), rng.normal(140, 60, m))
            sport = int(rng.integers(32768, 60000))
            tr = _mk(ts, 0, 0, 0, 0, _TCP, np.clip(sizes, 60, 1514), 0)
            tr["src"] = np.where(down, server, client).astype(np.uint32)
            tr["dst"] = np.where(down, client, server).astype(np.uint32)
            dp = 443 if rng.random() < 0.7 else 80
            tr["sport"] = np.where(down, dp, sport).astype(np.uint32)
            tr["dport"] = np.where(down, sport, dp).astype(np.uint32)
        elif kind == "dns":
            m = int(min(remaining, rng.integers(2, 6)))
            ts = t0 + np.cumsum(rng.exponential(0.05, m))
            down = np.arange(m) % 2 == 1
            sizes = np.where(down, rng.normal(220, 80, m), rng.normal(80, 15, m))
            sport = int(rng.integers(32768, 60000))
            tr = _mk(ts, 0, 0, 0, 0, _UDP, np.clip(sizes, 60, 512), 0)
            tr["src"] = np.where(down, server, client).astype(np.uint32)
            tr["dst"] = np.where(down, client, server).astype(np.uint32)
            tr["sport"] = np.where(down, 53, sport).astype(np.uint32)
            tr["dport"] = np.where(down, sport, 53).astype(np.uint32)
        elif kind == "ntp":
            m = int(min(remaining, 2))
            ts = t0 + np.array([0.0, rng.exponential(0.08)])[:m]
            tr = _mk(ts, client, server, 123, 123, _UDP,
                     np.full(m, 90.0), 0)
            if m == 2:
                tr["src"][1], tr["dst"][1] = server, client
        else:  # smtp
            m = int(min(remaining, rng.integers(6, 20)))
            ts = t0 + np.cumsum(rng.exponential(0.04, m))
            down = rng.random(m) < 0.3
            sizes = np.where(down, rng.normal(160, 40, m), rng.normal(700, 300, m))
            sport = int(rng.integers(32768, 60000))
            tr = _mk(ts, 0, 0, 0, 0, _TCP, np.clip(sizes, 60, 1514), 0)
            tr["src"] = np.where(down, server, client).astype(np.uint32)
            tr["dst"] = np.where(down, client, server).astype(np.uint32)
            tr["sport"] = np.where(down, 25, sport).astype(np.uint32)
            tr["dport"] = np.where(down, sport, 25).astype(np.uint32)
        traces.append(tr)
        remaining -= len(tr["ts"])
    out = _merge(traces)
    return {k: v[:n_packets] for k, v in out.items()}


# ---------------------------------------------------------------------------
# Attacks (statistical shapes from the published descriptions)
# ---------------------------------------------------------------------------
def _atk_syn_dos(n, t0, dur, rng):
    """Single-source TCP SYN flood on one server port: tiny pkts, high rate."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    return _mk(ts, _WAN + 0xBAD, _WAN + 1, int(rng.integers(1024, 65535)), 80,
               _TCP, rng.normal(60, 4, n).clip(54, 80), 1)


def _atk_ssdp_flood(n, t0, dur, rng):
    """SSDP amplification: many reflectors send large UDP 1900 to victim."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    refl = _WAN + 0x100 + rng.integers(0, 80, n).astype(np.uint32)
    tr = _mk(ts, 0, _LAN + 1, 1900, int(rng.integers(1024, 65535)), _UDP,
             rng.normal(1300, 120, n).clip(300, 1514), 1)
    tr["src"] = refl
    return tr


def _atk_os_scan(n, t0, dur, rng):
    """One source probes many hosts/ports with tiny TCP probes."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, _WAN + 0x5CA, 0, 40000, 0, _TCP,
             rng.normal(60, 3, n).clip(54, 74), 1)
    tr["dst"] = (_LAN + rng.integers(1, 60, n)).astype(np.uint32)
    tr["dport"] = rng.integers(1, 1024, n).astype(np.uint32)
    return tr


def _atk_mirai(n, t0, dur, rng):
    """Mirai: many infected LAN hosts telnet-scan (23/2323) + C&C beacons."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    bots = _LAN + 0x200 + rng.integers(0, 25, n).astype(np.uint32)
    tr = _mk(ts, 0, 0, 0, 0, _TCP, rng.normal(66, 8, n).clip(54, 120), 1)
    tr["src"] = bots
    tr["dst"] = (_LAN + rng.integers(1, 200, n)).astype(np.uint32)
    tr["sport"] = rng.integers(1024, 65535, n).astype(np.uint32)
    tr["dport"] = np.where(rng.random(n) < 0.9, 23, 2323).astype(np.uint32)
    return tr


def _atk_fuzzing(n, t0, dur, rng):
    """Protocol fuzzing: random sizes/ports to one server."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, _WAN + 0xF22, _WAN + 2, 0, 0, _TCP,
             rng.uniform(60, 1514, n), 1)
    tr["sport"] = rng.integers(1024, 65535, n).astype(np.uint32)
    tr["dport"] = rng.integers(1, 9000, n).astype(np.uint32)
    return tr


def _atk_arp_mitm(n, t0, dur, rng):
    """ARP MitM: victim traffic re-routed through attacker -> duplicated
    channel with shifted sizes/timing."""
    m = n // 2
    ts1 = t0 + np.sort(rng.uniform(0, dur, m))
    lat = rng.exponential(0.003, m)
    att = _LAN + 0x666
    a = _mk(ts1, _LAN + 3, att, 40000, 40001, _TCP,
            rng.normal(800, 350, m).clip(60, 1514), 1)
    b = _mk(ts1 + lat, att, _WAN + 1, 40001, 443, _TCP, a["length"], 1)
    return _merge([a, b])


def _atk_active_wiretap(n, t0, dur, rng):
    """Wiretap bridge adds latency + retransmissions on existing channels."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    retrans = rng.random(n) < 0.35
    sizes = np.where(retrans, 1514, rng.normal(900, 300, n)).clip(60, 1514)
    tr = _mk(ts, _LAN + 5, _WAN + 1, 45000, 443, _TCP, sizes, 1)
    down = rng.random(n) < 0.5
    tr["src"] = np.where(down, _WAN + 1, _LAN + 5).astype(np.uint32)
    tr["dst"] = np.where(down, _LAN + 5, _WAN + 1).astype(np.uint32)
    tr["sport"] = np.where(down, 443, 45000).astype(np.uint32)
    tr["dport"] = np.where(down, 45000, 443).astype(np.uint32)
    return tr


def _atk_ssl_renegotiation(n, t0, dur, rng):
    """THC-SSL-DoS: repeated renegotiation handshakes on 443."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, _WAN + 0x55D, _WAN + 1, 0, 443, _TCP,
             rng.normal(150, 60, n).clip(60, 600), 1)
    tr["sport"] = (40000 + (np.arange(n) % 64)).astype(np.uint32)
    return tr


def _atk_video_injection(n, t0, dur, rng):
    """Injected RTP video stream: constant large UDP bursts into a channel."""
    bursts = max(1, n // 12)
    ts = []
    for i in range(bursts):
        base = t0 + i * dur / bursts
        ts.append(base + np.cumsum(rng.exponential(0.0008, 12)))
    ts = np.sort(np.concatenate(ts)[:n])
    return _mk(ts, _LAN + 0x777, _LAN + 8, 5004, 5004, _UDP,
               rng.normal(1400, 60, n).clip(800, 1514), 1)


def _atk_ssh_bruteforce(n, t0, dur, rng):
    """Repeated short SSH sessions: bursts of small pkts on 22."""
    sess = max(1, n // 14)
    traces = []
    for i in range(sess):
        base = t0 + i * dur / sess + rng.exponential(0.1)
        m = 14
        ts = base + np.cumsum(rng.exponential(0.01, m))
        down = np.arange(m) % 2 == 1
        sizes = np.where(down, rng.normal(120, 30, m), rng.normal(90, 20, m))
        tr = _mk(ts, 0, 0, 0, 0, _TCP, sizes.clip(60, 300), 1)
        att, srv = _WAN + 0xB4F, _LAN + 2
        sport = 30000 + i % 2000
        tr["src"] = np.where(down, srv, att).astype(np.uint32)
        tr["dst"] = np.where(down, att, srv).astype(np.uint32)
        tr["sport"] = np.where(down, 22, sport).astype(np.uint32)
        tr["dport"] = np.where(down, sport, 22).astype(np.uint32)
        traces.append(tr)
    out = _merge(traces)
    return {k: v[:n] for k, v in out.items()}


def _atk_ftp_bruteforce(n, t0, dur, rng):
    tr = _atk_ssh_bruteforce(n, t0, dur, rng)
    tr["sport"] = np.where(tr["sport"] == 22, 21, tr["sport"]).astype(np.uint32)
    tr["dport"] = np.where(tr["dport"] == 22, 21, tr["dport"]).astype(np.uint32)
    return tr


def _atk_ddos_hulk(n, t0, dur, rng):
    """HULK: many sources, randomized HTTP GET floods on one server."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, 0, _WAN + 1, 0, 80, _TCP, rng.normal(350, 120, n).clip(60, 800), 1)
    tr["src"] = (_WAN + 0x2000 + rng.integers(0, 300, n)).astype(np.uint32)
    tr["sport"] = rng.integers(1024, 65535, n).astype(np.uint32)
    return tr


def _atk_ddos_loic(n, t0, dur, rng):
    """LOIC UDP flood: medium constant-size packets from many sources."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, 0, _WAN + 1, 0, 80, _UDP, rng.normal(500, 30, n).clip(200, 700), 1)
    tr["src"] = (_WAN + 0x3000 + rng.integers(0, 150, n)).astype(np.uint32)
    tr["sport"] = rng.integers(1024, 65535, n).astype(np.uint32)
    return tr


def _atk_goldeneye(n, t0, dur, rng):
    """GoldenEye: keep-alive HTTP floods, fewer sources, persistent sockets."""
    ts = t0 + np.sort(rng.uniform(0, dur, n))
    tr = _mk(ts, 0, _WAN + 1, 0, 80, _TCP, rng.normal(420, 90, n).clip(100, 900), 1)
    tr["src"] = (_WAN + 0x4000 + rng.integers(0, 12, n)).astype(np.uint32)
    tr["sport"] = (20000 + rng.integers(0, 40, n)).astype(np.uint32)
    return tr


def _atk_slowloris(n, t0, dur, rng):
    """Slowloris: many sockets, tiny pkts, very slow inter-arrival."""
    socks = 150
    per = max(1, n // socks)
    traces = []
    for i in range(socks):
        ts = t0 + np.sort(rng.uniform(0, dur, per))
        tr = _mk(ts, _WAN + 0x510, _WAN + 1, 25000 + i, 80, _TCP,
                 rng.normal(70, 8, per).clip(54, 120), 1)
        traces.append(tr)
    out = _merge(traces)
    return {k: v[:n] for k, v in out.items()}


ATTACKS: Dict[str, Callable] = {
    "mirai": _atk_mirai,
    "syn_dos": _atk_syn_dos,
    "ssdp_flood": _atk_ssdp_flood,
    "os_scan": _atk_os_scan,
    "fuzzing": _atk_fuzzing,
    "arp_mitm": _atk_arp_mitm,
    "active_wiretap": _atk_active_wiretap,
    "ssl_renegotiation": _atk_ssl_renegotiation,
    "video_injection": _atk_video_injection,
    "ssh_bruteforce": _atk_ssh_bruteforce,
    "ftp_bruteforce": _atk_ftp_bruteforce,
    "ddos_hulk": _atk_ddos_hulk,
    "ddos_loic": _atk_ddos_loic,
    "goldeneye": _atk_goldeneye,
    "slowloris": _atk_slowloris,
}


def attack_trace(name: str, n: int, t0: float, dur: float, seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    return ATTACKS[name](n, t0, dur, rng)


def synth_trace(attack: str, n_train: int = 20000, n_benign_eval: int = 20000,
                n_attack: int = 20000, seed: int = 0,
                rate_pps: float = 2000.0) -> Dict[str, Trace]:
    """Paper-style trace: benign prefix (training), then eval window with
    benign + attack interleaved. Returns {"train": ..., "eval": ...}."""
    rng = np.random.default_rng(seed)
    dur_train = n_train / rate_pps
    dur_eval = (n_benign_eval + n_attack) / rate_pps
    train = benign_trace(n_train, dur_train, rng)
    benign_ev = benign_trace(n_benign_eval, dur_eval, rng)
    benign_ev["ts"] += dur_train
    atk = attack_trace(attack, n_attack, dur_train + 0.1 * dur_eval,
                       0.8 * dur_eval, seed + 1)
    ev = _merge([benign_ev, atk])
    return {"train": train, "eval": ev}


def to_torch(trace: Trace, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Packet arrays as tensors on ``device`` (default ``cuda``), label
    dropped.  ``ts``/``length`` become float32; the uint32 address, port and
    protocol fields become int64 on the host first, so values of 2^31 and
    above (e.g. the ``0xC0000000`` WAN block) keep their unsigned order."""
    dev = resolve_device(device)
    out = {}
    for k, v in trace.items():
        if k == "label":
            continue
        a = np.asarray(v)
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int64)
        out[k] = torch.from_numpy(a).to(dev)
    return out
