"""The JAX package's quality and data scripts, ported.

Each runs as `python -m viai_tpu_torch.scripts.<name>` on the card (on
the CPU with `--device cpu`) and appends its record, with
`"package": "viai_tpu_torch"`, to `{--results_dir}/quality_results.jsonl`
(io/results.py), never to the JAX package's scripts/quality_results.jsonl:

  * quality_report: hole-PSNR before and after a short training;
  * av_ablation: the vision-infused model against the audio-only one;
  * quality_long: long runs on a pool of batches kept on the card,
    saving nets that cli.test loads;
  * grid_diag: pre-Griffin-Lim hole-PSNR, unseen clips against pool clips;
  * bayes_ceiling: the Monte-Carlo Bayes ceiling of the notes corpus;
  * cost_analysis: FLOPs and bytes of the main programs;
  * prepare_dataset: folders of wav and frame files from raw media.
"""
