from remora_tpu_torch.cli.main import run

if __name__ == "__main__":
    run()
