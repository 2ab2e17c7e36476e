"""Carry weights and optimizer state across from the JAX package.

The reference's MLPs are lists of ``{"w", "b"}`` layers with ``w`` of shape
``(in, out)`` for ``x @ w``; the port's ``nn.Linear`` weight is ``(out,
in)``, so ``w`` is transposed on the way in and out. Three param trees are
mapped:

* PPO's and TRPO's ``{"pi": [...], "log_std", "vf": [...]}`` onto
  ``MLPPolicy``;
* SAC's ``{"actor": [...], "critic": {"q1", "q2"}, "target_critic":
  {"q1", "q2"}, "log_alpha"}`` onto ``SACParams``, with its three Adam
  states (actor, critic, temperature);
* DDPG's ``{"actor", "critic", "target_actor", "target_critic"}`` (each a
  list of layers) onto ``DDPGParams``, with its two Adam states (actor,
  critic).

``PARAM_TREES`` names the two directions for each algorithm; the
checkpoints of both packages store the reference's tree.

The sequence model's ``init_params`` tree (``embed``, the stacked
``layers``, ``final_norm``, ``lm_head``, ``value_head``, ``meta_tokens``)
maps onto ``transformer.LM`` by name: its ``(in, out)`` matrices are kept
as they are (the port multiplies ``x @ w`` too), and the leading ``L`` axis
of ``layers`` is unstacked onto the per-layer modules. ``LMEnv``'s reward
table is carried across as it is.

Adam moments are lists in the order of the port's parameters (each layer's
weight, then bias). Inputs and outputs are numpy arrays (any array type
``np.asarray`` accepts), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.algos import ddpg, sac
from repro_torch.envs.lm_env import LMEnv
from repro_torch.models.mlp_policy import MLPPolicy
from repro_torch.models.transformer import LM
from repro_torch.optim.adam import AdamState


def _net(layers) -> List[np.ndarray]:
    """A reference MLP's arrays in ``nn.Linear`` parameter order."""
    out = []
    for lyr in layers:
        out += [np.asarray(lyr["w"]).T, np.asarray(lyr["b"])]
    return out


def _net_tree(arrays: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Inverse of ``_net``: ``[weight, bias, ...]`` -> reference layers."""
    return [{"w": np.asarray(w).T.copy(), "b": np.asarray(b).copy()}
            for w, b in zip(arrays[0::2], arrays[1::2])]


def _numpy(tensors) -> List[np.ndarray]:
    return [t.detach().cpu().numpy() for t in tensors]


def _copy_into(tensors: Sequence[torch.Tensor],
               arrays: Sequence[np.ndarray]) -> None:
    if len(tensors) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for {len(tensors)} "
                         f"parameters")
    with torch.no_grad():
        for p, x in zip(tensors, arrays):
            if tuple(p.shape) != np.shape(x):
                raise ValueError(f"shape mismatch: {np.shape(x)} for a "
                                 f"{tuple(p.shape)} parameter")
            p.copy_(torch.from_numpy(np.array(x, np.float32)))


def _adam(state, flatten: Callable, device) -> AdamState:
    step, mu, nu = state

    def moments(tree):
        return [torch.from_numpy(np.array(x, np.float32)).to(device)
                for x in flatten(tree)]

    return AdamState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                  device=device), moments(mu), moments(nu))


# ------------------------------------------------------------------ PPO
def _flat(tree) -> List[np.ndarray]:
    """The tree's arrays in ``MLPPolicy.parameters()`` order."""
    return [np.asarray(tree["log_std"])] + _net(tree["pi"]) + _net(tree["vf"])


def params_from_jax(tree: Dict[str, Any], device="cpu") -> MLPPolicy:
    """A reference params pytree (numpy leaves) -> ``MLPPolicy``."""
    pi, vf = tree["pi"], tree["vf"]
    obs_dim = np.asarray(pi[0]["w"]).shape[0]
    act_dim = np.asarray(pi[-1]["w"]).shape[1]
    hidden = np.asarray(pi[0]["w"]).shape[1]
    if len(pi) != len(vf):
        raise ValueError("pi and vf MLPs must have the same depth")
    policy = MLPPolicy(obs_dim, act_dim, hidden=hidden, depth=len(pi) - 1)
    _copy_into(list(policy.parameters()), _flat(tree))
    return policy.to(device)


def params_to_jax(policy: MLPPolicy) -> Dict[str, Any]:
    """``MLPPolicy`` -> the reference's params pytree of numpy arrays."""
    return {"pi": _net_tree(_numpy(policy.pi.parameters())),
            "log_std": policy.log_std.detach().cpu().numpy().copy(),
            "vf": _net_tree(_numpy(policy.vf.parameters()))}


def adam_state_from_jax(state, device="cpu") -> AdamState:
    """A reference ``AdamState(step, mu, nu)`` (numpy leaves, mu/nu shaped
    like the params pytree) -> the port's ``AdamState``."""
    return _adam(state, _flat, device)


# ------------------------------------------------------------------ SAC
def _critic(tree) -> List[np.ndarray]:
    return _net(tree["q1"]) + _net(tree["q2"])


def _critic_tree(arrays: Sequence[np.ndarray]) -> Dict[str, Any]:
    half = len(arrays) // 2
    return {"q1": _net_tree(arrays[:half]), "q2": _net_tree(arrays[half:])}


def _sac_groups(params: sac.SACParams) -> Tuple[List[torch.Tensor], ...]:
    return (list(params.actor.parameters()), list(params.critic.parameters()),
            list(params.target_critic.parameters()), [params.log_alpha])


def sac_params_from_jax(tree: Dict[str, Any], device="cpu") -> sac.SACParams:
    """A reference SAC params pytree (numpy leaves) -> ``SACParams``."""
    w0 = np.asarray(tree["actor"][0]["w"])
    act_dim = np.asarray(tree["actor"][-1]["w"]).shape[1] // 2
    params = sac.init_sac(torch.Generator(), w0.shape[0], act_dim,
                          hidden=w0.shape[1])
    arrays = (_net(tree["actor"]), _critic(tree["critic"]),
              _critic(tree["target_critic"]), [np.asarray(tree["log_alpha"])])
    for tensors, arrs in zip(_sac_groups(params), arrays):
        _copy_into(tensors, arrs)
    return params.to(device)


def sac_params_to_jax(params: sac.SACParams) -> Dict[str, Any]:
    """``SACParams`` -> the reference's SAC params pytree of numpy arrays."""
    actor, critic, target, log_alpha = map(_numpy, _sac_groups(params))
    return {"actor": _net_tree(actor), "critic": _critic_tree(critic),
            "target_critic": _critic_tree(target),
            "log_alpha": log_alpha[0].copy()}


_SAC_OPT_FLATTEN = (_net, _critic, lambda x: [np.asarray(x)])


def sac_adam_states_from_jax(states, device="cpu") -> Tuple[AdamState, ...]:
    """The reference's ``(actor, critic, alpha)`` Adam states -> the
    port's."""
    return tuple(_adam(s, f, device) for s, f in zip(states,
                                                     _SAC_OPT_FLATTEN))


def sac_adam_states_to_jax(states) -> Tuple[Tuple[int, Any, Any], ...]:
    """The port's three SAC Adam states -> ``(step, mu, nu)`` triples
    shaped like the reference's params pytrees (numpy leaves)."""
    def trees(arrays):
        return (_net_tree(arrays[0]), _critic_tree(arrays[1]),
                arrays[2][0].copy())

    mus = trees([_numpy(s.mu) for s in states])
    nus = trees([_numpy(s.nu) for s in states])
    return tuple((int(s.step), m, n) for s, m, n in zip(states, mus, nus))


# ----------------------------------------------------------------- DDPG
_DDPG_NETS = ("actor", "critic", "target_actor", "target_critic")


def ddpg_params_from_jax(tree: Dict[str, Any], device="cpu"
                         ) -> ddpg.DDPGParams:
    """A reference DDPG params pytree (numpy leaves) -> ``DDPGParams``."""
    w0 = np.asarray(tree["actor"][0]["w"])
    act_dim = np.asarray(tree["actor"][-1]["w"]).shape[1]
    params = ddpg.init_ddpg(torch.Generator(), w0.shape[0], act_dim,
                            hidden=w0.shape[1])
    for name in _DDPG_NETS:
        _copy_into(list(getattr(params, name).parameters()),
                   _net(tree[name]))
    return params.to(device)


def ddpg_params_to_jax(params: ddpg.DDPGParams) -> Dict[str, Any]:
    """``DDPGParams`` -> the reference's DDPG params pytree of numpy
    arrays."""
    return {name: _net_tree(_numpy(getattr(params, name).parameters()))
            for name in _DDPG_NETS}


def ddpg_adam_states_from_jax(states, device="cpu") -> Tuple[AdamState, ...]:
    """The reference's ``(actor, critic)`` Adam states -> the port's."""
    return tuple(_adam(s, _net, device) for s in states)


def ddpg_adam_states_to_jax(states) -> Tuple[Tuple[int, Any, Any], ...]:
    """The port's two DDPG Adam states -> ``(step, mu, nu)`` triples shaped
    like the reference's actor and critic layer lists (numpy leaves)."""
    return tuple((int(s.step), _net_tree(_numpy(s.mu)),
                  _net_tree(_numpy(s.nu)))
                 for s in states)


# ------------------------------------------------------------------- LM
def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_params_from_jax(cfg, tree: Dict[str, Any], device="cpu") -> LM:
    """A reference ``transformer.init_params`` tree (numpy leaves) ->
    ``LM`` on ``device``. Every parameter must be present with its shape;
    values pass through float32 into the parameter's dtype, which is exact
    for float32 and bfloat16 leaves."""
    flat = {}
    for key, x in _flatten(tree).items():
        x = np.array(x, np.float32)      # a writable copy
        if key.startswith("layers."):
            for i in range(x.shape[0]):
                flat[f"layers.{i}.{key[len('layers.'):]}"] = x[i]
        else:
            flat[key] = x
    model = LM(cfg, device=device)
    params = dict(model.named_parameters())
    if set(params) != set(flat):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(params) - set(flat))}, unknown "
                         f"{sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != flat[name].shape:
                raise ValueError(f"{name}: shape {flat[name].shape} for a "
                                 f"{tuple(p.shape)} parameter")
            p.copy_(torch.from_numpy(flat[name]))
    return model


def lm_params_to_jax(model: LM) -> Dict[str, Any]:
    """``LM`` -> the reference's tree of numpy arrays, per-layer parameters
    stacked on a leading ``L`` axis. Float32 parameters come out as they
    are; bfloat16 ones as their float32 values."""
    tree: Dict[str, Any] = {}
    stacked: Dict[str, List[np.ndarray]] = {}
    for name, p in model.named_parameters():
        x = p.detach().float().cpu().numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(rest, []).append(x)
            continue
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = x
    layers_tree = tree.setdefault("layers", {})
    for rest, xs in stacked.items():
        node = layers_tree
        *path, leaf = rest.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.stack(xs)
    return tree


def lm_env_from_jax(vocab_size: int, episode_len: int, reward_table,
                    repeat_penalty: float = 0.5, device="cpu") -> LMEnv:
    """The reference's ``LMEnv`` fields (its table as a numpy array) ->
    the port's ``LMEnv`` on ``device``."""
    table = torch.from_numpy(np.array(reward_table, np.float32))
    return LMEnv(vocab_size=vocab_size, episode_len=episode_len,
                 reward_table=table.to(device),
                 repeat_penalty=repeat_penalty)


# ----------------------------------------------------------- checkpoints
# each RL algorithm's params as the reference's params pytree and back:
# what a checkpoint stores (``checkpoint.save``) and restores
# (``serve.load_policy``), so a checkpoint written by either package
# restores in the other
PARAM_TREES: Dict[str, Tuple[Callable, Callable]] = {
    "ppo": (params_to_jax, params_from_jax),
    "trpo": (params_to_jax, params_from_jax),
    "sac": (sac_params_to_jax, sac_params_from_jax),
    "ddpg": (ddpg_params_to_jax, ddpg_params_from_jax),
}
