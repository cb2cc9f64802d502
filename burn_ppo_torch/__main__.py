from burn_ppo_torch.cli import main

raise SystemExit(main())
