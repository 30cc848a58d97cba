"""The port's serving launcher ``repro_torch.launch.serve`` on the CPU.

``main([..., "--device", "cpu"])`` on reduced gemma3-1b measures the
decode step per batch size, drives the simulated Packrat server through
a rate step, completes every request and prints the reference's three
kinds of line (``repro/launch/serve.py``: the request count, the
latency summary, one line per reconfiguration).  The encoder-decoder
and vision-prefix families run the same loop.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

LINES = {
    "count": re.compile(r"\[serve\] arch=(\S+) requests=(\d+) "
                        r"completed=(\d+)$"),
    "latency": re.compile(r"\[serve\] latency mean=\d+\.\dms "
                          r"p50=\d+\.\dms p99=\d+\.\dms$"),
    "reconfig": re.compile(r"\[serve\] t= *\d+\.\ds reconfig B= *\d+ -> "
                           r"\[.+\] L=\d+\.\d+ms$"),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_completes_every_request_on_cpu(capsys):
    assert serve.main(["--arch", "gemma3-1b", "--duration", "4",
                       "--rate-step", "2", "--units", "4",
                       "--initial-batch", "2", "--max-batch", "8",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    kinds = [next((k for k, rx in LINES.items() if rx.match(ln)), ln)
             for ln in lines]
    assert kinds[:2] == ["count", "latency"]
    assert set(kinds[2:]) == {"reconfig"} and len(kinds) >= 4
    arch, requests, completed = LINES["count"].match(lines[0]).groups()
    assert arch == "gemma3-1b" and int(requests) == int(completed) > 0


def test_make_torch_runner_runs_a_decode_step_per_batch():
    make_runner = serve.make_torch_runner("mamba2-130m", seq_len=16,
                                          device="cpu")
    for b in (1, 4):
        assert make_runner(b)() is None


def test_serve_runs_reduced_deepseek_on_cpu(capsys):
    """deepseek-v2-236b's reduced config (MLA, dense prefix, MoE of 8
    experts top-2) through the whole loop: every request completes."""
    assert serve.main(["--arch", "deepseek-v2-236b", "--duration", "2",
                       "--rate-step", "1", "--units", "4",
                       "--initial-batch", "2", "--max-batch", "4",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    arch, requests, completed = LINES["count"].match(lines[0]).groups()
    assert arch == "deepseek-v2-236b" and int(requests) == int(completed) > 0
    assert LINES["latency"].match(lines[1])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_unported_families_raise(arch, capsys):
    """The encoder-decoder (its cache holds a seq_len-frame cross
    memory) and the vision-prefix families serve: every request
    completes through the whole loop."""
    assert serve.main(["--arch", arch, "--duration", "2",
                       "--rate-step", "1", "--units", "4",
                       "--initial-batch", "2", "--max-batch", "4",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got, requests, completed = LINES["count"].match(lines[0]).groups()
    assert got == arch and int(requests) == int(completed) > 0
    assert LINES["latency"].match(lines[1])


def test_serve_raises_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_torch_runner("gemma3-1b")
