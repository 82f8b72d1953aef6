"""One module per architecture, ``arch/<name>.py``, found by the name in the
configuration file's ``architecture`` key ("pangu" where the file has none,
``harness.architecture``). It holds all that the harness knows of that
architecture, and the architecture modules are the only benchmark code that
touches the program under test (``pangu_tpu_torch``); the kernel files' work
functions are the program's kernels' own and may read their shapes too.

The contract (``FORECAST``, which every cell needs). Each function takes the
configuration file as a dict, ``config``:

- ``TINY``: the model keys that cut a configuration to a geometry the CPU
  tests run in seconds.
- The program: ``build_kernels()`` builds what the program compiles, into
  the checkout; ``build_model(cell, seed, device)`` -> (the program's
  configuration, the model on ``device`` holding the seed's weights);
  ``aux_constants(k)`` -> what the program's steps take beside a state;
  ``forecast_step(model, aux)`` -> ``step(*state)``, which returns the next
  state.
- The inputs, drawn from ``--seed`` on the streams of ``inputs.py``:
  ``weights(config, seed, device)``, the parameters by name, which the
  program loads and the reference reads; ``constants(config, seed, device)``
  -> ``k``; ``states(config, k, seed, device, count, batch)`` -> ``count``
  states. A state is a tuple of tensors of any length, and a step maps it to
  a state of the same shapes.
- The reference: ``reference_step(params, config, state, k, precision)``
  -> the plain reference's next state in its own form, computed in
  ``precision`` (``PRECISIONS``: "f32", or a control's "tf32" or "fp8");
  ``to_state(out, k)`` -> that output as a state the program takes.
- The comparison: ``forecast_gaps(state, out, k)`` -> ``{"rel_rms": ...,
  "max_abs": ...}``, the program's next state against the reference's
  ``out``.
- The work: ``forward_matmul_flops(config, batch)``, the product FLOPs of
  one forecast step.

Training (``TRAINING``), which a ``train`` cell needs besides:
``pairs(config, k, seed, device, traffic)`` -> ``traffic["pool"]`` (input,
target) pairs, each one tuple; ``batch(*pair)``, the pair as the train step
takes it; ``train_step(model, cfg, steps_per_epoch)`` -> (``step(batch, aux,
generator)`` -> loss, its ``torch.optim.Adam``); ``first_moments(optimizer,
model)`` -> Adam's first moment of every parameter by name;
``reference_steps(config, k, pairs, seed, device, precision)`` -> the
reference's ``losses``, first ``grad`` norms and ``update`` norms, as
``compare.train_gaps`` takes them; ``train_matmul_flops(config, batch)``.

A roofline metric also reads ``blocks(config)``: one tuple per block, the
shape arguments that the kernel files' ``work`` takes before the batch.
"""

FORECAST = ("TINY", "build_kernels", "build_model", "aux_constants", "forecast_step",
            "weights", "constants", "states", "reference_step", "to_state", "forecast_gaps",
            "forward_matmul_flops")
TRAINING = ("pairs", "batch", "train_step", "first_moments", "reference_steps",
            "train_matmul_flops")
PRECISIONS = ("f32", "tf32", "fp8")
