from kube_scheduler_simulator_tpu_torch.simulator import main

main()
