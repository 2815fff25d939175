from radmmm_torch.server import main

main()
