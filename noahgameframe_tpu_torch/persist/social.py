"""KV-backed persistence for the social systems (mail, rank, guild).

Reference: `NFServer/NFDataAgent_NosqlPlugin/` — each social system
persists its own Redis keys as it mutates, independent of player blobs
and whole-world checkpoints.  Same seam here: the agent binds a
:class:`~noahgameframe_tpu_torch.persist.kv.KVStore` to the social modules and
write-through-saves on every mutation:

- ``mail:<account>``  — the account's mailbox (JSON);
- ``rank:<list>``     — one named score list (JSON);
- ``guild:<name>``    — durable guild membership by ACCOUNT (JSON).

Guilds need the account indirection: live ``GroupInfo`` rosters hold
entity guids, which die at logout (the membership module removes
destroyed members on purpose).  The durable truth is the account set;
when a member logs back in, :meth:`SocialDataAgent` re-links them — the
guild entity is resurrected on the first returning member (who holds
interim leadership until the saved leader returns) and each member
re-joins as they arrive.  A leave caused by entity destruction
(``destroy_cleanup``) keeps durable membership; a voluntary leave drops
it.

A copy of ``noahgameframe_tpu/persist/social.py``, which imports no jax:
the port keeps its own, over the port's ``persist/kv.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Set

from ..core.datatypes import Guid
from .kv import KVStore

MAIL_PREFIX = "mail:"
RANK_PREFIX = "rank:"
GUILD_PREFIX = "guild:"


class SocialDataAgent:
    """Write-through KV persistence + login re-link for social state."""

    def __init__(self, kv: KVStore) -> None:
        self.kv = kv
        self.kernel = None
        self.mail = None
        self.rank = None
        self.guilds = None
        # durable guild rosters: name -> {"leader": account,
        # "members": [account, ...], "capacity": int}
        self._guild_records: Dict[str, dict] = {}

    # ------------------------------------------------------------- bind
    def bind(self, kernel, mail=None, rank=None, guilds=None) -> "SocialDataAgent":
        self.kernel = kernel
        if mail is not None:
            self.mail = mail
            self._load_mail()
            mail.on_dirty = self._save_mailbox
        if rank is not None:
            self.rank = rank
            self._load_rank()
            rank.on_dirty = self._save_rank
        if guilds is not None:
            self.guilds = guilds
            self._load_guilds()
            guilds.on_membership_event = self._on_guild_event
            # a dormant guild (all members offline, entity dissolved)
            # still owns its name — strangers must not merge into its
            # durable record by re-creating the name
            guilds.name_taken = lambda n: n in self._guild_records
            from ..kernel.kernel import ObjectEvent

            def on_player(guid: Guid, _cn: str, ev) -> None:
                if ev == ObjectEvent.CREATE_FINISH:
                    self.relink(guid)

            kernel.register_class_event(on_player, "Player")
        return self

    # ------------------------------------------------------------- mail
    def _load_mail(self) -> None:
        from ..game.social import Mail

        meta = self.kv.get(MAIL_PREFIX + "__meta__")
        if meta:
            self.mail._next_id = int(json.loads(meta)["next_id"])
        for key in self.kv.keys(MAIL_PREFIX + "*"):
            account = key[len(MAIL_PREFIX):]
            if account == "__meta__":
                continue
            raw = self.kv.get(key)
            if raw:
                self.mail._boxes[account] = [
                    Mail(**m) for m in json.loads(raw)
                ]

    def _save_mailbox(self, account: str) -> None:
        box = self.mail._boxes.get(account, [])
        key = MAIL_PREFIX + account
        if box:
            self.kv.set(key, json.dumps(
                [dataclasses.asdict(m) for m in box]).encode())
        else:
            self.kv.delete(key)
        self.kv.set(MAIL_PREFIX + "__meta__",
                    json.dumps({"next_id": self.mail._next_id}).encode())

    # ------------------------------------------------------------- rank
    def _load_rank(self) -> None:
        for key in self.kv.keys(RANK_PREFIX + "*"):
            raw = self.kv.get(key)
            if raw:
                self.rank._lists[key[len(RANK_PREFIX):]] = {
                    k: int(v) for k, v in json.loads(raw).items()
                }

    def _save_rank(self, list_name: str) -> None:
        entries = self.rank._lists.get(list_name, {})
        key = RANK_PREFIX + list_name
        if entries:
            self.kv.set(key, json.dumps(entries).encode())
        else:
            self.kv.delete(key)

    # ------------------------------------------------------------ guilds
    def _account_of(self, guid: Guid) -> Optional[str]:
        if self.kernel is None or guid not in self.kernel.store.guid_map:
            return None
        acct = str(self.kernel.get_property(guid, "Account"))
        return acct or None

    def _load_guilds(self) -> None:
        self._guild_records = {}
        for key in self.kv.keys(GUILD_PREFIX + "*"):
            raw = self.kv.get(key)
            if raw:
                self._guild_records[key[len(GUILD_PREFIX):]] = json.loads(raw)

    def _persist_guild(self, name: str) -> None:
        key = GUILD_PREFIX + name
        rec = self._guild_records.get(name)
        if rec and rec["members"]:
            self.kv.set(key, json.dumps(rec).encode())
        else:
            self._guild_records.pop(name, None)
            self.kv.delete(key)

    def _on_guild_event(self, event: str, g, member, cleanup: bool) -> None:
        if not g.name:
            return  # unnamed groups (teams) are transient by design
        rec = self._guild_records.setdefault(
            g.name, {"leader": "", "members": [], "capacity": g.capacity})
        acct = self._account_of(member) if member is not None else None
        if event == "create":
            rec["leader"] = acct or rec["leader"]
            if acct and acct not in rec["members"]:
                rec["members"].append(acct)
        elif event == "join":
            if acct and acct not in rec["members"]:
                rec["members"].append(acct)
        elif event == "leave":
            # logout keeps durable membership; walking out drops it
            if not cleanup and acct in rec["members"]:
                rec["members"].remove(acct)
                if rec["leader"] == acct and rec["members"]:
                    rec["leader"] = rec["members"][0]
        elif event == "disband":
            rec["members"] = []
        # entity dissolve with surviving durable members (last member
        # logged out) keeps the record — relink resurrects the guild
        self._persist_guild(g.name)

    def relink(self, guid: Guid) -> None:
        """Re-attach a logging-in player to their durable guild: first
        returning member resurrects the guild entity (interim leader);
        the saved leader reclaims leadership on return."""
        acct = self._account_of(guid)
        if acct is None or self.guilds is None:
            return
        for name, rec in list(self._guild_records.items()):
            if acct not in rec["members"]:
                continue
            info = self.guilds.find_by_name(name)
            # resurrect/re-join without re-firing durable bookkeeping,
            # and with the dormant-name reservation lifted for ourselves
            cb = self.guilds.on_membership_event
            taken = self.guilds.name_taken
            self.guilds.on_membership_event = None
            self.guilds.name_taken = None
            try:
                if info is None:
                    self.guilds.create_guild(guid, name)
                elif guid not in info.members:
                    self.guilds.join(info.group_id, guid)
            finally:
                self.guilds.on_membership_event = cb
                self.guilds.name_taken = taken
            info = self.guilds.find_by_name(name)
            if info is not None and rec["leader"] == acct:
                info.leader = guid
                self.kernel.set_property(info.group_id, "LeaderID", guid)
            return  # at most one guild per player
