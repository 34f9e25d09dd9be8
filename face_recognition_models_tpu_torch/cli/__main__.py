from face_recognition_models_tpu_torch.cli.main import main

raise SystemExit(main())
