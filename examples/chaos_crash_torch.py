"""Crash-recovery chaos smoke on the PyTorch port: SIGKILL the durable
server mid-stream, restart it from WAL + snapshot, and demand the final
state line (engine fingerprint + match digest over a fixed query set) be
identical to a control run that never crashed (the port's counterpart of
``examples/chaos_crash.py``).

The victim is ``serve_queries_torch.py --wal`` (deterministic, resumable
update stream).  SIGKILL, not SIGTERM, lands at a random update tick (or
the one ``--kill-epoch`` pins), so over many runs the kill exercises the
whole protocol: mid-WAL-append (torn tail), between log and apply (replay
of the logged epoch), mid-snapshot (a manifest-less step that restore
skips).  The restarted run recovers, finishes the remaining epochs, and
must print the same ``[wal] final ...`` line as the control.  The server
runs on the card (``--device cuda``, the default) or with ``--device cpu``
on the CPU.

    PYTHONPATH=src python examples/chaos_crash_torch.py [--n 1200] [--updates 8]
    PYTHONPATH=src python examples/chaos_crash_torch.py --kill-epoch 3  # pin the tick
"""
import argparse
import os
import random
import re
import signal
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_FINAL = re.compile(r"\[wal\] final epoch=(\d+) fingerprint=(\w+) match_digest=(\w+)")


def _cmd(args, wal_dir):
    return [
        sys.executable, os.path.join(_HERE, "serve_queries_torch.py"),
        "--n", str(args.n),
        "--wal", wal_dir,
        "--wal-updates", str(args.updates),
        "--snapshot-every", str(args.snapshot_every),
        "--device", args.device,
    ]


def _env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(_HERE), "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_to_completion(args, wal_dir, tag):
    p = subprocess.run(_cmd(args, wal_dir), env=_env(), capture_output=True, text=True,
                       timeout=900)
    sys.stdout.write(p.stdout)
    if p.returncode != 0:
        sys.stderr.write(p.stderr)
        raise SystemExit(f"[chaos] {tag} run failed with rc={p.returncode}")
    m = _FINAL.search(p.stdout)
    if not m:
        raise SystemExit(f"[chaos] {tag} run printed no final state line")
    return m.groups()


def run_and_kill(args, wal_dir, kill_epoch):
    """Start the victim, SIGKILL it the moment epoch ``kill_epoch`` is
    durable: the next tick (log, apply, maybe snapshot) dies mid-flight."""
    p = subprocess.Popen(_cmd(args, wal_dir), env=_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    killed = False
    try:
        for line in p.stdout:
            sys.stdout.write(line)
            if f"[wal] epoch {kill_epoch}/" in line:
                os.kill(p.pid, signal.SIGKILL)
                killed = True
                break
    finally:
        p.stdout.close()
        if not killed and p.poll() is None:
            p.kill()
        rc = p.wait(timeout=120)
    if not killed:
        raise SystemExit(f"[chaos] victim finished (rc={rc}) before epoch {kill_epoch}")
    print(f"[chaos] SIGKILLed victim at epoch {kill_epoch} (rc={rc})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--snapshot-every", type=int, default=3)
    ap.add_argument(
        "--kill-epoch", type=int, default=None,
        help="update tick after which to SIGKILL (default: random mid-stream)",
    )
    ap.add_argument("--seed", type=int, default=None, help="seed the random kill tick")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs: the card (default) or 'cpu'")
    args = ap.parse_args()

    rng = random.Random(args.seed)
    kill_epoch = args.kill_epoch or rng.randrange(1, args.updates)

    with tempfile.TemporaryDirectory() as control_dir, \
            tempfile.TemporaryDirectory() as victim_dir:
        print("[chaos] control run (no crash) ...")
        control = run_to_completion(args, control_dir, "control")

        print(f"[chaos] victim run, SIGKILL after epoch {kill_epoch} ...")
        run_and_kill(args, victim_dir, kill_epoch)

        print("[chaos] restarting victim from WAL + snapshot ...")
        recovered = run_to_completion(args, victim_dir, "recovered")

    if recovered != control:
        raise SystemExit(
            f"[chaos] MISMATCH after recovery: control={control} recovered={recovered}"
        )
    print(
        f"[chaos] ok: recovered replica identical to control "
        f"(epoch={control[0]} fingerprint={control[1]} digest={control[2]})"
    )


if __name__ == "__main__":
    main()
