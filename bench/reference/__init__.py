"""The plain references of the benchmark, one module an architecture, and
AdamW (``adamw.py``). A configuration file names its module by
``"reference": "<name>"`` (``bench/reference/<name>.py``; ``model`` where
it names none), and ``spec.reference`` loads it from the cell's root, so a
new architecture brings its reference as a new file. Such a module:

- exports ``forward(w, cfg, tokens, prec, remat)``, the logits (B, S, V) in
  fp32 of tokens (B, S), and ``loss(w, cfg, tokens, prec, remat)``, the
  mean next-token cross-entropy over all positions but the last, from the
  weights by their paths in the port's tree (``bench/weights.py``) and the
  configuration file's keys; ``prec`` is ``fp32``, ``tf32`` or ``fp8``, as
  ``model.mm`` takes it (the controls compute in the lower two); ``remat``
  recomputes each layer in the backward;
- exports ``counts(cfg)``, the architecture's counts that ``bench/flops.py``
  and the metrics read: ``matmul_params``, the parameters a token meets in
  products over the stack of layers (a MoE's router and top-k experts; the
  unembedding not counted); ``params``, every parameter (a tied embedding
  once); ``attn_layers``, the layers with softmax attention, and their
  ``heads``, ``kv_heads``, ``qk_head_dim`` and ``v_head_dim``;
  ``mixer_flops``, the forward FLOPs a token spends over the stack in
  mixers beyond products with weights and attention's (query, key) pairs,
  such as a scan;
- imports nothing of the program and takes only the weights and inputs the
  benchmark made; it may reuse ``model.py``'s helpers (``mm``, ``linear``,
  ``rmsnorm``, ``rope``, ``attention``, ...).
"""
