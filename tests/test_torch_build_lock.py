"""The kernel build across processes (``ops/hopper/_build.py``): two
processes that call ``build()`` at once on a stale build directory compile
each source once and link once, and both get the same library; so do two
threads of one process (the file lock is taken on a file of each caller's
own opening, so it excludes threads too).

A fake ``nvcc`` first on ``PATH`` logs each call and sleeps, so the two
builds overlap; ``BUILD_DIR`` and ``LIB_PATH`` point at a temporary
directory.  Nothing here needs the CUDA toolkit.
"""
import os
import subprocess
import sys
import textwrap
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    kind = "link" if "-shared" in args else "compile"
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write(f"{{kind}} {{os.path.basename(out)}} {{os.getppid()}}\\n")
    time.sleep(1.0)
    with open(out, "w") as f:
        f.write(kind)
''')

CALLER = textwrap.dedent('''\
    import os, sys, time
    sys.path.insert(0, {root!r})
    from paddle_tpu_torch.ops.hopper import _build
    _build.BUILD_DIR = {build!r}
    _build.LIB_PATH = os.path.join({build!r}, "lib.so")
    # both callers start build() together
    open(os.path.join({gate!r}, str(os.getpid())), "w").close()
    deadline = time.monotonic() + 30
    while len(os.listdir({gate!r})) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    print(_build.build())
''')


def test_two_processes_build_once(tmp_path):
    from paddle_tpu_torch.ops.hopper import _build

    bindir, build, gate = (tmp_path / d for d in ("bin", "build", "gate"))
    for d in (bindir, gate):
        d.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}",
           "FAKE_NVCC_LOG": str(log)}
    code = CALLER.format(root=ROOT, build=str(build), gate=str(gate))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lib = str(build / "lib.so")
    assert [out.strip() for out, _ in outs] == [lib, lib]
    calls = log.read_text().split()
    kinds = calls[0::3]
    targets = calls[1::3]
    objs = sorted(os.path.basename(s).replace(".cu", ".o")
                  for s in _build.SOURCES)
    assert sorted(t for k, t in zip(kinds, targets)
                  if k == "compile") == objs, calls
    assert kinds.count("link") == 1, calls
    # one builder process ran every nvcc
    assert len(set(calls[2::3])) == 1, calls
    assert open(lib).read() == "link"
    assert sorted(os.listdir(build)) == sorted(objs + ["build.lock",
                                                       "lib.so"])


def test_two_threads_build_once(tmp_path, monkeypatch):
    from paddle_tpu_torch.ops.hopper import _build

    bindir, build = tmp_path / "bin", tmp_path / "build"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "LIB_PATH", str(build / "lib.so"))
    gate = threading.Barrier(2, timeout=30)
    got, errors = [], []

    def call():
        try:
            gate.wait()
            got.append(_build.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert got == [str(build / "lib.so")] * 2
    kinds = log.read_text().split()[0::3]
    assert kinds.count("compile") == len(_build.SOURCES), kinds
    assert kinds.count("link") == 1, kinds
