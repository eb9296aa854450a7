"""The port's entry points, counterparts of the repository's ``apps/``:

  track_video      YOLO detections carried through a video by the mask tracker
                   (online or semi-online with voting), ``Annotations/`` PNGs and
                   ``pred.json``;
  auto_speed_calc  the batch needle-speed CLI over a video or a directory;
  evaluate_speed   the speed pipeline against hand-labelled key frames;
  speed_freq       speed histograms from stored lengths;
  serve            the HTTP detector server with dynamic batching;
  app              ``yolo_inference`` (image and video mode, U²-Net on the
                   needle crops) and the gradio UI, behind its optional import;
  webui            the app's web UI on the standard library's http.server;
  yolo_cli         ``predict`` with ``key=value`` arguments (training's
                   subcommands are not ported yet).

Each module has the JAX app's flags, endpoints and output lines; its
``main(argv, device=None)`` runs on the card unless ``device="cpu"`` is passed
(there is no device flag, as the JAX CLIs have none).  ``python -m
yolo_puncture_tpu_torch.apps.<name> --help`` lists the flags.
"""
