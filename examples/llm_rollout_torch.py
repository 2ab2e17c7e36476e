"""RLHF-style token rollouts on the PyTorch port (the counterpart of
``examples/llm_rollout.py``).

An assigned architecture (default ``mixtral-8x7b-reduced``) is the policy;
experience collection is autoregressive decode against a synthetic token
reward model (N decode samplers, each prefilling a batch of prompts and
decoding ``--gen-len`` tokens); the learner is token-level PPO, one step an
update. On the card the rollout goes through the flash-attention,
decode-attention and selective-scan kernels (the archs that have them) and
the advantages through the GAE kernel; the train step runs the model's
plain paths.

As in the reference, the learner's context is the last prompt token then
the generated tokens but the last (``[prompt[:, -1:], tokens[:, :-1]]``),
not the whole prompt, so its log-probs differ from the behaviour log-probs
even at the first epoch.

  PYTHONPATH=src python examples/llm_rollout_torch.py [--arch hymba-1.5b]
  PYTHONPATH=src python examples/llm_rollout_torch.py --device cpu \\
      --updates 2 --samplers 1 --batch 2 --gen-len 4          # small
"""
import argparse
import time

import torch

from repro_torch.algos.gae import gae, normalize
from repro_torch.algos.ppo import PPOConfig, make_lm_train_step
from repro_torch.configs import get_config
from repro_torch.core.sampler import make_lm_rollout
from repro_torch.core.timing import synchronize
from repro_torch.envs import lm_env
from repro_torch.experiment import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adam


def main(argv=None):
    """Run the loop; returns ``(cfg, params, history)``, ``history`` one
    dict per update (mean token reward, loss, collect and learn
    seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b-reduced")
    ap.add_argument("--updates", type=int, default=6)
    ap.add_argument("--samplers", type=int, default=2,
                    help="decode samplers an update")
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences a sampler")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen)
    env = lm_env.make(cfg.vocab_size, episode_len=args.gen_len,
                      device=device)
    rollout = make_lm_rollout(cfg, env, args.gen_len)
    opt = adam(3e-4)
    opt_state = opt.init(list(params.parameters()))
    train = make_lm_train_step(cfg, opt, PPOConfig(entropy_coef=0.003))

    history = []
    for it in range(args.updates):
        t0 = time.perf_counter()
        trajs = [rollout(params,
                         torch.randint(0, cfg.vocab_size,
                                       (args.batch, args.prompt_len),
                                       generator=gen, device=device),
                         generator=gen)
                 for _ in range(args.samplers)]   # N decode samplers
        traj = {k: torch.cat([t[k] for t in trajs]) for k in trajs[0]}
        synchronize(device)
        collect = time.perf_counter() - t0

        # GAE over token rewards (values ~ 0 baseline for the demo)
        rew_tm = traj["rewards"].T.contiguous()          # (T, B)
        zeros = torch.zeros_like(rew_tm)
        adv, ret = gae(rew_tm, zeros, torch.zeros_like(rew_tm, dtype=bool),
                       torch.zeros(rew_tm.shape[1], device=device),
                       0.99, 0.95)
        context = torch.cat([traj["prompt"][:, -1:],
                             traj["tokens"][:, :-1]], dim=1)
        batch = {"tokens": context, "targets": traj["tokens"],
                 "behavior_logp": traj["logp"],
                 "advantages": normalize(adv.T), "returns": ret.T,
                 "mask": torch.ones_like(traj["logp"])}
        if cfg.frontend_embeds:
            batch["extra_embeds"] = torch.zeros(
                (context.shape[0], cfg.frontend_embeds, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train(params, opt_state, batch)
        synchronize(device)
        learn = time.perf_counter() - t0
        history.append({"mean_token_reward": float(traj["rewards"].mean()),
                        "loss": float(metrics["loss"]),
                        "collect_s": collect, "learn_s": learn})
        print(f"update {it}: mean token reward "
              f"{history[-1]['mean_token_reward']:+.3f}  "
              f"loss={history[-1]['loss']:.3f}  collect={collect:.2f}s "
              f"learn={learn:.2f}s  ({args.samplers} samplers x "
              f"{args.batch} seqs x {args.gen_len} tokens)", flush=True)
    return cfg, params, history


if __name__ == "__main__":
    main()
