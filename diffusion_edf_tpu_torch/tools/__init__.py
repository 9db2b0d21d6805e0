"""The model-building drivers of the JAX repository's ``tools/``, one module
each, every one with ``main(argv)`` and ``python -m
diffusion_edf_tpu_torch.tools.<name>`` (the JAX tool's options plus
``--device``, ``cuda`` unless the caller asks for ``cpu``):

* ``gen_cascade_samples`` -- a cascade's final samples on demo scenes with
  their true pose errors, the ``.npz`` dump the critic fine-tune reads;
* ``train_critic_cascade`` -- the EBM critic fine-tuned with the rank loss
  on those dumps, selected on held-out executed success;
* ``sweep_schedule`` -- inference schedules evaluated per split, and the
  winner that the evaluation and the dumps run;
* ``train_eval_loop`` -- the trainer with periodic held-out evaluation,
  best-checkpoint selection and a float16 export;
* ``k_truncation_report`` -- how often a radius search's static cap clips a
  neighbourhood, per call site.

Every dump, report and export is in the JAX tools' format, so either
package's tools read what the other's wrote."""
