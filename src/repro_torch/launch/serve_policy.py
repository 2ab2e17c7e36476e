"""Policy serving driver: load a trained checkpoint, serve ``act()``
requests with dynamic batching, optionally follow a live params channel
(port of ``repro/launch/serve_policy.py``).

Train, then serve (on the CUDA device unless ``--device cpu`` is given):

  # 1. train and checkpoint (either package's train CLI)
  PYTHONPATH=src python -m repro_torch.launch.train --env pendulum \\
      --algo ppo --iterations 5 --ckpt-dir /tmp/ckpt
  # 2. serve it: 8 slots, 5 ms batching window, 64 requests from 4
  #    concurrent clients, with a live hot-swap mid-traffic
  PYTHONPATH=src python -m repro_torch.launch.serve_policy --ckpt /tmp/ckpt \\
      --slots 8 --deadline-ms 5 --requests 64 --clients 4 --swap-after 16

The traffic driver: ``--requests N`` synthetic observations (from
``--seed``) fired by ``--clients`` concurrent threads, each a blocking
``act()`` caller; the serving-stats snapshot is printed as JSON.
``--swap-after K`` exercises the hot-swap in-process: the CLI stands in for
a learner and publishes perturbed params on a ``ParamsChannel`` after K
completions, and exits nonzero unless the server picked up the new version
with every request completed. ``--channel-spec FILE`` instead attaches to
an external learner's channel (its ``ChannelSpec.to_json`` handoff file;
the channel must carry the port's parameters in module order).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time
import uuid

import numpy as np

from repro_torch.core.ipc import ChannelSpec, ParamsChannel, param_leaves
from repro_torch.serve import PolicyServer, load_policy


def _drive_traffic(server: PolicyServer, handle, args, channel) -> int:
    """Fire ``--requests`` blocking acts from ``--clients`` threads;
    returns the number of completions observed."""
    rng = np.random.RandomState(args.seed)
    observations = rng.randn(args.requests,
                             handle.env.obs_dim).astype(np.float32)
    publish_at = (args.swap_after
                  if args.swap_after and not args.channel_spec else None)
    done_count = 0

    def one(i):
        return server.act(observations[i], timeout=args.timeout)

    with concurrent.futures.ThreadPoolExecutor(args.clients) as pool:
        futures = [pool.submit(one, i) for i in range(args.requests)]
        for fut in concurrent.futures.as_completed(futures):
            fut.result()                        # propagate request errors
            done_count += 1
            if publish_at is not None and done_count >= publish_at:
                # the CLI doubles as the learner: publish perturbed params
                # mid-traffic, as a training run does
                leaves = [x * np.float32(1.01)
                          for x in param_leaves(handle.params)]
                version = channel.publish(leaves)
                print(f"# published params version {version} after "
                      f"{done_count} completions", file=sys.stderr)
                publish_at = None
    return done_count


def main(argv=None) -> dict:
    """Parse ``argv``, serve the traffic; returns the printed snapshot
    (exits nonzero unless every request completed and, under
    ``--swap-after``, the version advanced)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory written by launch/train.py "
                         "--ckpt-dir (rl mode; metadata names env+algo)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--slots", type=int, default=8,
                    help="fixed device batch width per dispatch")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="max wait of the oldest queued request before a "
                         "partial batch dispatches")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="admission bound (default 16*slots); a full "
                         "queue rejects with ServerOverloaded")
    ap.add_argument("--requests", type=int, default=64,
                    help="synthetic traffic: total act() requests")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent blocking act() client threads")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="per-request completion timeout (seconds)")
    ap.add_argument("--swap-after", type=int, default=0,
                    help="after this many completions, publish perturbed "
                         "params on a live ParamsChannel and require the "
                         "server to pick up the new version (0: off)")
    ap.add_argument("--channel-spec", default=None,
                    help="attach to an external learner's ParamsChannel: "
                         "path to its ChannelSpec JSON handoff file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    handle = load_policy(args.ckpt, args.step, device=args.device)
    print(f"# serving {handle.name} from {args.ckpt} "
          f"(obs_dim={handle.env.obs_dim}, act_dim={handle.env.act_dim}) "
          f"on {next(handle.params.parameters()).device}", file=sys.stderr)

    channel = None
    if args.channel_spec:
        with open(args.channel_spec) as f:
            channel = ParamsChannel.attach(ChannelSpec.from_json(f.read()))
    elif args.swap_after:
        # in-process learner stand-in for the hot-swap demo and smoke
        leaves = param_leaves(handle.params)
        channel = ParamsChannel.create(
            leaves, f"walle-{os.getpid()}-serve-{uuid.uuid4().hex[:6]}")
        channel.publish(leaves)                  # version 1 = the ckpt

    t0 = time.perf_counter()
    try:
        server = PolicyServer(handle.env, handle.algo, handle.params,
                              slots=args.slots, deadline_ms=args.deadline_ms,
                              queue_cap=args.queue_cap, seed=args.seed,
                              params_channel=channel)
        with server:
            start_version = server.params_version
            completed = _drive_traffic(server, handle, args, channel)
            if args.swap_after and not args.channel_spec:
                # traffic can drain before the publish lands; keep a
                # trickle flowing until the server observes the new
                # version (the pickup itself is what the smoke asserts)
                probe = np.zeros(handle.env.obs_dim, np.float32)
                deadline = time.monotonic() + 30.0
                while (server.params_version <= start_version
                       and time.monotonic() < deadline):
                    server.act(probe, timeout=args.timeout)
        snap = server.snapshot()
        snap["wall_seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(snap, indent=2))
        if completed != args.requests:
            sys.exit(f"FAIL: {completed}/{args.requests} requests "
                     f"completed")
        if args.swap_after and not args.channel_spec:
            if server.params_version <= start_version:
                sys.exit(f"FAIL: params version never advanced past "
                         f"{start_version} despite --swap-after "
                         f"{args.swap_after}")
            print(f"# hot-swap observed: version {start_version} -> "
                  f"{server.params_version}", file=sys.stderr)
    finally:
        if channel is not None:
            channel.close(unlink=not args.channel_spec)
    return snap


if __name__ == "__main__":
    main()
