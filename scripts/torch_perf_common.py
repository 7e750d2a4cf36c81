"""What the port's measurement scripts share (scripts/torch_bench.py,
torch_profile_genome.py, torch_roofline_searchresolve.py,
torch_microbench.py, torch_dp_bench.py, torch_gather_bench*.py,
torch_onchip_suite.py, torch_bigbuild.py): the device a script runs on,
timing with the device's queue drained, the card's memory rate, and the
chained row gathers of the gather benches and the search + resolve
roofline, eager and captured in a CUDA graph. Imports no JAX.
"""

import subprocess
import time

import torch

# HBM peak of the cards a ratio is taken against (NVIDIA's data sheet,
# the rate PERF.md's bounds use); on any other card no ratio is printed
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, the card) or cpu; a missing card "
                         "is an error, never a fallback")


def open_device(name: str) -> torch.device:
    """The torch device ``name`` names; SystemExit when it is a card and
    there is none."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device (no fallback "
                             "to the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise SystemExit(f"--device {name}: cuda or cpu")
    return dev


def sync(dev: torch.device) -> None:
    """Waits for the device's queued work (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def describe(dev: torch.device) -> str:
    """The device a number was taken on: on a card its name, the count of
    cards, and its name and power limit as nvidia-smi gives them."""
    if dev.type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return (f"{dev} {torch.cuda.get_device_name(dev)} "
            f"({torch.cuda.device_count()} visible; {smi})")


def times(fn, dev: torch.device, n: int = 5, warm: int = 1) -> list:
    """Seconds of each of ``n`` calls of ``fn``, each ended by draining
    the device's queue, after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    sync(dev)
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def hbm_peak(dev: torch.device):
    """(the card's HBM bytes/s, None), or (None, why no ratio is taken)."""
    if dev.type != "cuda":
        return None, "no HBM peak on the CPU"
    name = torch.cuda.get_device_name(dev)
    if name not in HBM_PEAK:
        return None, f"no HBM peak known for {name!r}"
    return HBM_PEAK[name], None


def chain(tab: torch.Tensor, nmod: int, K: int):
    """K DEPENDENT row gathers as a callable of the first rows' indices
    (int64 [B]): step k gathers rows ``i`` of ``tab``, sums each row in
    int64, and the next rows are ``(i + sum) % nmod``, so that no step
    can start before the one before it has read its rows. Returns the
    sum of the last indices (a 0-d tensor on the device)."""
    def run(i):
        for _ in range(K):
            i = (i + tab[i].sum(-1, dtype=torch.int64)) % nmod
        return i.sum()
    return run


def graphed(fn, *args):
    """``fn(*args)`` captured once in a CUDA graph over copies of
    ``args``: a callable that replays it and returns its output tensor.
    The counterpart of one jit program: the graph launches every kernel
    of the call at once, with no host work between them."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)  # warm outside the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*static)

    def replay():
        g.replay()
        return out
    return replay


def chain_times(tab, nmod, i0, K, dev, n=4):
    """Best seconds of the K-step chain (``chain``) from ``i0``, each run
    ended by copying its one scalar back: {"eager": s, "graph": s}, the
    graph's None on the CPU (no CUDA graphs there)."""
    run = chain(tab, nmod, K)
    out = {"eager": min(times(lambda: run(i0).item(), dev, n)),
           "graph": None}
    if dev.type == "cuda":
        replay = graphed(run, i0)
        out["graph"] = min(times(lambda: replay().item(), dev, n))
        del replay
    return out


def per_gather(tab, nmod, i0, k1, k2, dev, n=4):
    """Seconds of one gather of the chain, (t(k2) - t(k1)) / (k2 - k1),
    eager and graphed (None on the CPU), with both ends:
    {mode: (per, t(k1), t(k2))}."""
    a = chain_times(tab, nmod, i0, k1, dev, n)
    b = chain_times(tab, nmod, i0, k2, dev, n)
    return {m: None if a[m] is None else
            ((b[m] - a[m]) / (k2 - k1), a[m], b[m]) for m in a}


def gbs(nbytes: float, secs: float) -> float:
    """GB/s of nbytes in secs (0 for a time that is not positive: a
    difference of two noisy times can be)."""
    return nbytes / secs / 1e9 if secs > 0 else 0.0
