from petastorm_tpu_torch.benchmark.cli import main

raise SystemExit(main())
