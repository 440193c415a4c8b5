"""A closed loop of offline batches through the program's LM serving
engine: ``ServeEngine.submit`` for every prompt of a batch, then ``run``,
which forms one wave a prompt length, prefills it and returns each
request's token; the next batch goes in when ``run`` returns.

Set-up draws the weights, builds the engine and runs one whole batch
(batch 0), so every wave shape of the window is warm.  The window opens
before batch 1 and closes when the first batch that ends past ``seconds``
returns, and not before the batches the check reads have run: it holds
whole batches only.

The check reads what the timed path produced.  A forward hook on the LM
keeps each wave's last-position logits (the rows the engine takes its
argmax from), and every request of the window must have been served the
argmax of its row.  The engine forms a wave from the queued prompts of one
length in submission order, so request j of that length in a batch is row
j of its wave.

The program's logits are not held against the reference's whole forward:
with top-8 of 64 experts, a token whose 8th and 9th router probabilities
lie within rounding of each other picks another expert in bf16 than in
float32 (2% of the tokens of a layer, each moving that token's expert
output by ~40%), and over 16 layers such flips reach the last position as
often in the bf16 program as in a float8 reference.  So the check follows
the program layer by layer instead: for every wave of the window's first
``check_batches`` batches, a wrapper around the LM's ``_apply_layer`` keeps
each layer's input (the previous layer's output) and the last layer's
output, and the plain reference computes every layer again from the
program's own input, the wave's tokens routed together under the
configuration's expert capacity.  Each token's error is held by a high
quantile over the wave's tokens, which the few tokens on a router tie stay
under and a fault in any tenth of the rows does not, and each request's
last position, the only one its served token depends on, by a quantile of
its own.  The stages this skips are checked by themselves: the embedding
rows against the table, and the logits against the reference's head on the
program's final state.
"""
from __future__ import annotations

import importlib
import sys

import numpy as np
import torch

from bench import traffic as traffic_mod
from bench import weights


#: the quantile of a wave's token errors held by ``layer_err``: the ~2% of
#: tokens on a router tie lie above it, a fault in more than a tenth of
#: the rows does not
TOKEN_Q = 0.9
#: the quantile of a layer's last-position errors held by ``last_err``
LAST_Q = 0.75


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor (its
    largest magnitude onto 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.spec, self.seed = config, traffic, seed
        self.device = device
        self.ref = importlib.import_module(
            f"bench.references.{config['reference']}")
        self.batches: list[dict] = []
        self._rows: dict = {}         # (batch, length) -> (B, V) logits
        self._batch = 0
        self.waves = (0, 0)
        # (batch, length) -> layer inputs, then the last layer's output
        self._states: dict = {}
        self._capturing = False

    def _model_config(self):
        from repro_torch.configs.base import ModelConfig, MoEConfig
        c = self.cfg
        return ModelConfig(
            name=c["name"], arch_type="moe", num_layers=c["num_layers"],
            d_model=c["d_model"], num_heads=c["num_heads"],
            num_kv_heads=c["num_kv_heads"], head_dim=c["head_dim"], d_ff=0,
            vocab_size=c["vocab_size"], qk_norm=c["qk_norm"],
            moe=MoEConfig(num_experts=c["num_experts"], top_k=c["top_k"],
                          d_ff_expert=c["d_ff_expert"]),
            gated_mlp=True, mlp_act="silu", rope_theta=c["rope_theta"],
            norm_eps=c["norm_eps"], dtype=c["dtype"])

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from repro_torch.models.moe import Parallel
        from repro_torch.models.transformer import LM
        from repro_torch.serve.engine import ServeEngine

        mc = self._model_config()
        if mc.padded_vocab != self.cfg["padded_vocab"]:
            raise ValueError("padded_vocab disagrees with the program's")
        self.lm = LM(mc, device=self.device).eval()
        weights.fill_module(self.lm, self.ref.weight_groups(self.cfg),
                            self.seed)
        self._watch(self.lm)
        self.engine = ServeEngine(mc, self.lm,
                                  max_len=self.spec["max_len"],
                                  par=Parallel())
        self._run_batch(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _watch(self, lm):
        """Keep what the check reads: every wave's last-position logits (a
        forward hook), and in the checked batches each layer's input and
        the last layer's output (a wrapper of the LM's ``_apply_layer``)."""
        V = self.cfg["vocab_size"]
        n = self.cfg["num_layers"]

        def keep(module, args, out):
            logits = out[0]
            self._rows[(self._batch, logits.shape[1])] = \
                logits[:, -1, :V].float()

        self._hook = lm.register_forward_hook(keep)
        apply = lm._apply_layer

        def apply_layer(layer, x, *args, **kwargs):
            out = apply(layer, x, *args, **kwargs)
            if self._capturing:
                st = self._states.setdefault((self._batch, x.shape[1]), [])
                st.append(x.clone())
                if len(st) == n:
                    st.append(out[0].clone())
            return out

        lm._apply_layer = apply_layer

    def _run_batch(self, b: int) -> dict:
        self._batch = b
        prompts = traffic_mod.prompt_batch(self.spec, self.seed, b,
                                           self.cfg["vocab_size"])
        rids = [self.engine.submit(p.tokens, max_new=self.spec["max_new"])
                for p in prompts]
        self._capturing = 1 <= b <= self.spec["check_batches"]
        out = self.engine.run()
        self._capturing = False
        return {"index": b, "prompts": prompts, "rids": rids, "out": out}

    # -- the window ---------------------------------------------------------
    def run_window(self, seconds: float, window) -> None:
        w0 = self.engine.stats["waves"]
        window.begin()
        b = 1
        while True:
            self.batches.append(self._run_batch(b))
            b += 1
            if window.over(seconds) and b > self.spec["check_batches"]:
                break
        window.end()
        self.waves = (w0, self.engine.stats["waves"])

    def facts(self) -> dict:
        """Prompt lengths of the window's batches, their tokens, and the
        engine's waves in the window."""
        lengths = [len(p.tokens) for bt in self.batches
                   for p in bt["prompts"]]
        return {"lengths": lengths, "tokens": sum(lengths),
                "batches": len(self.batches),
                "waves": self.waves[1] - self.waves[0]}

    def attempted_failed(self) -> tuple[int, int]:
        n = sum(len(bt["rids"]) for bt in self.batches)
        bad = sum(1 for bt in self.batches for r in bt["rids"]
                  if len(bt["out"].get(r, [])) != self.spec["max_new"])
        return n, bad

    # -- the check ----------------------------------------------------------
    def _row(self, bt: dict, pos: int) -> torch.Tensor:
        """The logits row request ``pos`` of batch ``bt`` was served from."""
        L = len(bt["prompts"][pos].tokens)
        j = sum(1 for p in bt["prompts"][:pos] if len(p.tokens) == L)
        return self._rows[(bt["index"], L)][j]

    def check(self, control: bool = False) -> dict:
        """The compared numbers.  Exact (limit 0): ``not_argmax``, window
        requests whose served token is not the argmax of their logits row;
        ``embed_err``, the largest |program − table| of the checked
        batches' embedding rows.  Against the float32 reference computed
        from the program's own state, over the checked batches, with a
        token's error ‖program − reference‖ / ‖reference − input‖ (its
        error as a share of what the layer adds): ``layer_err``, over
        layers and waves the largest ``TOKEN_Q`` quantile over a wave's
        tokens; ``last_err``, over layers the largest ``LAST_Q`` quantile
        over the requests' last positions; ``head_err``, the largest
        root-mean-square of program − reference logits as a share of the
        reference's.  With ``control``, {"program": ..., "control": ...},
        the control being the reference computed through float8 in the
        program's place."""
        wrong = 0
        for bt in self.batches:
            for pos, rid in enumerate(bt["rids"]):
                toks = bt["out"].get(rid, [])
                if not toks or toks[0] != int(self._row(bt, pos).argmax()):
                    wrong += 1
        n_layers = self.cfg["num_layers"]
        checked = self.batches[:self.spec["check_batches"]]
        waves, whole = {}, len(checked) == self.spec["check_batches"]
        for bt in checked:
            lengths = {len(p.tokens) for p in bt["prompts"]}
            for L in lengths:
                st = self._states.get((bt["index"], L), [])
                ids = [p.tokens for p in bt["prompts"] if len(p.tokens) == L]
                whole = whole and len(st) == n_layers + 1 and \
                    st[0].shape[0] == len(ids)
                waves[(bt["index"], L)] = {
                    "states": st, "ids": np.stack(ids),
                    "logits": self._rows[(bt["index"], L)]}
        self._states = {}
        # the program's state goes before the reference runs
        self._hook.remove()
        del self.lm, self.engine
        self._rows = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        groups = self.ref.weight_groups(self.cfg)

        def fetch(g):
            return weights.draw_group(groups[g], self.seed, g, self.device)

        if whole:
            out = self._follow(waves, fetch, control)
        else:
            inf = float("inf")
            out = {m: dict.fromkeys(
                ("layer_err", "last_err", "head_err", "embed_err"), inf)
                for m in ("program", "control")}
        out["program"]["not_argmax"] = float(wrong)
        if control:
            out["control"]["not_argmax"] = 0.0
            return out
        return out["program"]

    def _follow(self, waves, fetch, control) -> dict:
        """Every layer and the head of the checked waves, from the
        program's own inputs, against the reference (and its control)."""
        ref = self.ref
        modes = ["program"] + (["control"] if control else [])
        worst = {m: dict.fromkeys(
            ("layer_err", "last_err", "head_err", "embed_err"), 0.0)
            for m in modes}
        emb = fetch(0)["embedding"]
        for wv in waves.values():
            ids = torch.as_tensor(wv["ids"], device=emb.device).long()
            worst["program"]["embed_err"] = max(
                worst["program"]["embed_err"],
                float((wv["states"][0].float() - emb[ids].float())
                      .abs().max()))
        del emb
        norms = ref.float_group(fetch, 2)
        stats = {}
        for li in range(self.cfg["num_layers"]):
            w = ref.float_group(fetch, 3 + li)
            w.update(norms)
            last = {m: [] for m in modes}
            for wv in waves.values():
                x_in = wv["states"][li].float()
                want = ref.layer(w, self.cfg, li, x_in, stats=stats)
                scale = (want - x_in).norm(dim=-1)
                got = {"program": wv["states"][li + 1].float()}
                if control:
                    got["control"] = ref.layer(w, self.cfg, li, x_in,
                                               quant=fp8)
                for m in modes:
                    e = (got[m] - want).norm(dim=-1) / scale
                    worst[m]["layer_err"] = max(
                        worst[m]["layer_err"],
                        float(torch.quantile(e.flatten(), TOKEN_Q)))
                    last[m].append(e[:, -1])
                del want, got, x_in
            for m in modes:
                worst[m]["last_err"] = max(
                    worst[m]["last_err"],
                    float(torch.quantile(torch.cat(last[m]), LAST_Q)))
            del w
        print(f"[bench] checked batches: the reference drops "
              f"{stats.get('dropped', 0)} of {stats.get('pairs', 0)} "
              f"(token, expert) pairs at the configuration's capacity",
              file=sys.stderr)
        head_w = ref.float_group(fetch, 1)["lm_head.weight"]
        for wv in waves.values():
            final = wv["states"][-1][:, -1].float()
            want = ref.head(norms, head_w, self.cfg, final)
            got = {"program": wv["logits"]}
            if control:
                got["control"] = ref.head(norms, head_w, self.cfg, final,
                                          quant=fp8)
            for m in modes:
                e = (got[m] - want).pow(2).mean(-1).sqrt() / \
                    want.pow(2).mean(-1).sqrt()
                worst[m]["head_err"] = max(worst[m]["head_err"],
                                           float(e.max()))
        return worst
