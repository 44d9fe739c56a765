from tpuserve_torch.server.openai_api import main

if __name__ == "__main__":
    main()
