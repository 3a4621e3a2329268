"""The port's command line (counterpart of tell_tpu/commands/, `tnt`):
`python -m tell_tpu_torch.commands {train,evaluate,preprocess,serve,score}
...`. Importing runs nothing."""
