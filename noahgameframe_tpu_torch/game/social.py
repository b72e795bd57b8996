"""Social & meta systems: team, mail, rank, shop, friends, guild, GM, PVP.

Reference modules: NFCGSTeamModule (team CRUD + member sync), mail with
attachments (NFMidWare/NFMailPlugin + DataAgent mail redis module),
NFCRankModule (score lists), NFCSLGShopModule (buy → bag), Friend/Guild
plugins (NFMidWare skeletons backed by DataAgent redis modules),
NFCGmModule (chat-command cheats gated by GMLevel) and NFCGSPVPMatchModule
(queue pairing).  All of these are control-plane (rare ops, host dicts +
entity properties/records) — exactly where the reference keeps them; the
tick path is untouched.

Where a module touches entity state it goes through the kernel so the
usual flag/diff machinery broadcasts the change (e.g. TeamID/GuildID are
Public OBJECT properties).

A copy of ``noahgameframe_tpu/game/social.py``, which imports no jax: the
port keeps its own.  ``PvpMatchModule`` reads the wall clock only where no
``now=`` is given, as there.
"""

from __future__ import annotations

import collections
import dataclasses
import time as _time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..core.datatypes import Guid, NULL_GUID
from ..kernel.module import Module

# ============================================================ membership


@dataclasses.dataclass
class GroupInfo:
    group_id: Guid
    leader: Guid
    members: List[Guid] = dataclasses.field(default_factory=list)
    capacity: int = 5
    name: str = ""

    @property
    def team_id(self) -> Guid:  # reference-parity spelling
        return self.group_id

    @property
    def guild_id(self) -> Guid:
        return self.group_id


class _MembershipModule(Module):
    """Shared team/guild mechanics: an entity-backed group whose members
    carry its guid in an OBJECT property; no double-join, capacity cap,
    leadership handoff, dissolve-when-empty, and automatic removal when a
    member entity is destroyed (logout/death cleanup)."""

    entity_class = "Team"
    member_prop = "TeamID"

    def __init__(self, capacity: int) -> None:
        super().__init__()
        self.capacity = capacity
        self.groups: Dict[Guid, GroupInfo] = {}
        # persistence hook: (event, group, member, destroy_cleanup) with
        # event in create/join/leave/disband/dissolve — destroy_cleanup
        # marks a leave caused by entity destruction (logout), which must
        # NOT drop durable membership (persist.social.SocialDataAgent)
        self.on_membership_event = None
        self._destroy_cleanup = False

    def _fire(self, event: str, g: GroupInfo, member=None) -> None:
        if self.on_membership_event is not None:
            self.on_membership_event(event, g, member, self._destroy_cleanup)

    def after_init(self) -> None:
        from ..kernel.kernel import ObjectEvent

        def on_event(guid: Guid, _cname: str, ev) -> None:
            # BEFORE_DESTROY: the member's row is still live, so the
            # membership property write and count updates all succeed
            if ev == ObjectEvent.BEFORE_DESTROY and self.group_of(guid):
                self._destroy_cleanup = True
                try:
                    self.leave(guid)
                finally:
                    self._destroy_cleanup = False

        self.kernel.register_class_event(on_event)

    def _set_member_prop(self, member: Guid, group_id: Guid) -> None:
        store = self.kernel.store
        if member not in store.guid_map:
            return  # member entity already destroyed
        cname, _ = store.row_of(member)
        if store.spec(cname).has_property(self.member_prop):
            self.kernel.set_property(member, self.member_prop, group_id)

    def _create_group(self, leader: Guid, name: str = "") -> Optional[Guid]:
        if self.group_of(leader) is not None:
            return None
        values = {"LeaderID": leader, "MemberCount": 1}
        if name:
            values["Name"] = name
        group_id = self.kernel.create_object(self.entity_class, values)
        self.groups[group_id] = GroupInfo(group_id, leader, [leader],
                                          self.capacity, name)
        self._set_member_prop(leader, group_id)
        self._fire("create", self.groups[group_id], leader)
        return group_id

    def group_of(self, member: Guid) -> Optional[GroupInfo]:
        for g in self.groups.values():
            if member in g.members:
                return g
        return None

    def join(self, group_id: Guid, member: Guid) -> bool:
        g = self.groups.get(group_id)
        if g is None or member in g.members or len(g.members) >= g.capacity:
            return False
        if self.group_of(member) is not None:
            return False
        g.members.append(member)
        self._set_member_prop(member, group_id)
        self.kernel.set_property(group_id, "MemberCount", len(g.members))
        self._fire("join", g, member)
        return True

    def leave(self, member: Guid) -> bool:
        g = self.group_of(member)
        if g is None:
            return False
        g.members.remove(member)
        self._set_member_prop(member, NULL_GUID)
        self._fire("leave", g, member)
        if not g.members:
            self._dissolve(g)
            self._fire("dissolve", g)
            return True
        if g.leader == member:
            g.leader = g.members[0]  # leadership passes down
            self.kernel.set_property(g.group_id, "LeaderID", g.leader)
        self.kernel.set_property(g.group_id, "MemberCount", len(g.members))
        return True

    def disband(self, leader: Guid) -> bool:
        g = self.group_of(leader)
        if g is None or g.leader != leader:
            return False
        for m in list(g.members):
            self._set_member_prop(m, NULL_GUID)
        self._dissolve(g)
        self._fire("disband", g)
        return True

    def _dissolve(self, g: GroupInfo) -> None:
        del self.groups[g.group_id]
        self.kernel.destroy_object(g.group_id)

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        return {
            "groups": [
                {
                    "group_id": str(g.group_id),
                    "leader": str(g.leader),
                    "members": [str(m) for m in g.members],
                    "capacity": g.capacity,
                    "name": g.name,
                }
                for g in self.groups.values()
            ]
        }

    def restore_state(self, data: dict) -> None:
        self.groups = {}
        for gd in data.get("groups", []):
            gid = Guid.parse(gd["group_id"])
            self.groups[gid] = GroupInfo(
                gid,
                Guid.parse(gd["leader"]),
                [Guid.parse(m) for m in gd["members"]],
                int(gd["capacity"]),
                gd.get("name", ""),
            )


# ===================================================================== team


TeamInfo = GroupInfo  # reference-parity aliases


class TeamModule(_MembershipModule):
    """Team CRUD (NFCGSTeamModule); members carry the Public TeamID
    property so the sync spine broadcasts membership."""

    name = "TeamModule"
    entity_class = "Team"
    member_prop = "TeamID"

    def __init__(self, capacity: int = 5) -> None:
        super().__init__(capacity)

    @property
    def teams(self) -> Dict[Guid, GroupInfo]:
        return self.groups

    def create_team(self, leader: Guid) -> Optional[Guid]:
        return self._create_group(leader)

    def team_of(self, member: Guid) -> Optional[GroupInfo]:
        return self.group_of(member)


# ===================================================================== mail


@dataclasses.dataclass
class Mail:
    mail_id: int
    sender: str
    title: str
    body: str
    gold: int = 0
    items: Dict[str, int] = dataclasses.field(default_factory=dict)
    sent_at: float = 0.0  # logical time: kernel tick at send
    read: bool = False
    drawn: bool = False


class MailModule(Module):
    """Account-keyed mailboxes with gold/item attachments; drawing pays
    through the wallet and the bag (reference mail flow)."""

    name = "MailModule"

    def __init__(self, pack=None, keep: int = 100) -> None:
        super().__init__()
        self.pack = pack  # items.PackModule for attachment delivery
        self.keep = keep
        self._boxes: Dict[str, List[Mail]] = {}
        self._next_id = 1
        self.on_dirty = None  # fn(account) — persistence write-through

    def _mark(self, account: str) -> None:
        if self.on_dirty is not None:
            self.on_dirty(account)

    def send(self, to_account: str, sender: str, title: str, body: str = "",
             gold: int = 0, items: Optional[Dict[str, int]] = None) -> int:
        # stamp with the kernel tick, not the wall clock: mail state must
        # be a pure function of journaled inputs for record/replay
        k = self.kernel
        sent_at = float(k.tick_count) if k is not None else 0.0
        mail = Mail(self._next_id, sender, title, body, gold,
                    dict(items or {}), sent_at)
        self._next_id += 1
        box = self._boxes.setdefault(to_account, [])
        box.append(mail)
        del box[: max(0, len(box) - self.keep)]
        self._mark(to_account)
        return mail.mail_id

    def mailbox(self, account: str) -> List[Mail]:
        return list(self._boxes.get(account, []))

    def _find(self, account: str, mail_id: int) -> Optional[Mail]:
        for m in self._boxes.get(account, []):
            if m.mail_id == mail_id:
                return m
        return None

    def read(self, account: str, mail_id: int) -> Optional[Mail]:
        m = self._find(account, mail_id)
        if m is not None:
            m.read = True
            self._mark(account)
        return m

    def draw(self, account: str, mail_id: int, player: Guid) -> bool:
        """Claim attachments: items to the bag first (a full bag fails the
        whole draw, leaving the mail claimable later), then gold."""
        m = self._find(account, mail_id)
        if m is None or m.drawn:
            return False
        k = self.kernel
        if m.items:
            if self.pack is None:
                return False
            delivered = []
            for config_id, count in m.items.items():
                if not self.pack.create_item(player, config_id, count):
                    for cid, n in delivered:  # roll back partial delivery
                        self.pack.delete_item(player, cid, n)
                    return False
                delivered.append((config_id, count))
        if m.gold:
            k.set_property(player, "Gold",
                           int(k.get_property(player, "Gold")) + m.gold)
        m.drawn = True
        m.read = True
        self._mark(account)
        return True

    def delete(self, account: str, mail_id: int) -> bool:
        box = self._boxes.get(account, [])
        n = len(box)
        self._boxes[account] = [m for m in box if m.mail_id != mail_id]
        if len(self._boxes[account]) != n:
            self._mark(account)
            return True
        return False

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        return {
            "next_id": self._next_id,
            "boxes": {
                acct: [dataclasses.asdict(m) for m in box]
                for acct, box in self._boxes.items()
            },
        }

    def restore_state(self, data: dict) -> None:
        self._next_id = int(data.get("next_id", 1))
        self._boxes = {
            acct: [Mail(**m) for m in box]
            for acct, box in data.get("boxes", {}).items()
        }


# ===================================================================== rank


class RankModule(Module):
    """Named score lists with top-N queries (NFCRankModule).  Scores are
    pushed (e.g. on level-up/fight-power change); storage is a plain dict
    — rank reads are rare relative to the tick."""

    name = "RankModule"

    def __init__(self) -> None:
        super().__init__()
        self._lists: Dict[str, Dict[str, int]] = {}  # list -> key -> score
        self.on_dirty = None  # fn(list_name) — persistence write-through

    def _mark(self, list_name: str) -> None:
        if self.on_dirty is not None:
            self.on_dirty(list_name)

    def update(self, list_name: str, key: str, score: int) -> None:
        self._lists.setdefault(list_name, {})[key] = int(score)
        self._mark(list_name)

    def remove(self, list_name: str, key: str) -> None:
        if self._lists.get(list_name, {}).pop(key, None) is not None:
            self._mark(list_name)

    def score(self, list_name: str, key: str) -> Optional[int]:
        return self._lists.get(list_name, {}).get(key)

    def top(self, list_name: str, n: int = 10) -> List[Tuple[str, int]]:
        entries = self._lists.get(list_name, {})
        return sorted(entries.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    def rank_of(self, list_name: str, key: str) -> Optional[int]:
        """1-based rank, None if absent."""
        entries = self._lists.get(list_name, {})
        if key not in entries:
            return None
        my = entries[key]
        return 1 + sum(1 for k, v in entries.items()
                       if v > my or (v == my and k < key))

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        return {"lists": self._lists}

    def restore_state(self, data: dict) -> None:
        self._lists = {
            ln: {k: int(v) for k, v in entries.items()}
            for ln, entries in data.get("lists", {}).items()
        }


# ===================================================================== shop


class ShopModule(Module):
    """Buy an item element for its BuyPrice in Gold → bag
    (NFCSLGShopModule shape: config-driven catalogue)."""

    name = "ShopModule"

    def __init__(self, pack) -> None:
        super().__init__()
        self.pack = pack

    def price_of(self, config_id: str) -> Optional[int]:
        """None = not purchasable (unknown element or no positive
        BuyPrice) — a missing price must never mean "free"."""
        elems = self.kernel.elements
        if not elems.exists(config_id):
            return None
        price = int(elems.element(config_id).values.get("BuyPrice", 0) or 0)
        return price if price > 0 else None

    def buy(self, player: Guid, config_id: str, count: int = 1) -> bool:
        price = self.price_of(config_id)
        if price is None or count <= 0:
            return False
        k = self.kernel
        total = price * count
        gold = int(k.get_property(player, "Gold"))
        if gold < total:
            return False
        if not self.pack.create_item(player, config_id, count):
            return False
        k.set_property(player, "Gold", gold - total)
        return True

    def sell(self, player: Guid, config_id: str, count: int = 1) -> bool:
        elems = self.kernel.elements
        if not elems.exists(config_id):
            return False
        price = int(elems.element(config_id).values.get("SalePrice", 0) or 0)
        if not self.pack.delete_item(player, config_id, count):
            return False
        k = self.kernel
        k.set_property(player, "Gold",
                       int(k.get_property(player, "Gold")) + price * count)
        return True


# ===================================================================== friends


class FriendModule(Module):
    """Mutual friend lists + block lists, account-keyed (NFMidWare
    NFFriendPlugin backed by the DataAgent friend redis module)."""

    name = "FriendModule"

    def __init__(self, max_friends: int = 50) -> None:
        super().__init__()
        self.max_friends = max_friends
        self._friends: Dict[str, List[str]] = {}
        self._blocked: Dict[str, List[str]] = {}

    def add_friend(self, a: str, b: str) -> bool:
        if a == b or b in self._blocked.get(a, []) or a in self._blocked.get(b, []):
            return False
        fa = self._friends.setdefault(a, [])
        fb = self._friends.setdefault(b, [])
        if b in fa or len(fa) >= self.max_friends or len(fb) >= self.max_friends:
            return False
        fa.append(b)
        fb.append(a)
        return True

    def remove_friend(self, a: str, b: str) -> bool:
        fa = self._friends.get(a, [])
        if b not in fa:
            return False
        fa.remove(b)
        fb = self._friends.get(b, [])
        if a in fb:
            fb.remove(a)
        return True

    def friends(self, account: str) -> List[str]:
        return list(self._friends.get(account, []))

    def block(self, a: str, b: str) -> None:
        self.remove_friend(a, b)
        blocked = self._blocked.setdefault(a, [])
        if b not in blocked:
            blocked.append(b)

    def unblock(self, a: str, b: str) -> None:
        if b in self._blocked.get(a, []):
            self._blocked[a].remove(b)

    def blocked(self, account: str) -> List[str]:
        return list(self._blocked.get(account, []))

    # ------------------------------------------------- checkpoint/resume
    def checkpoint_state(self) -> dict:
        return {"friends": self._friends, "blocked": self._blocked}

    def restore_state(self, data: dict) -> None:
        self._friends = {k: list(v) for k, v in data.get("friends", {}).items()}
        self._blocked = {k: list(v) for k, v in data.get("blocked", {}).items()}


# ===================================================================== guild


GuildInfo = GroupInfo


class GuildModule(_MembershipModule):
    """Guild registry over the shared membership base; guilds are Guild
    entities with unique names; members carry GuildID."""

    name = "GuildModule"
    entity_class = "Guild"
    member_prop = "GuildID"

    def __init__(self, capacity: int = 50) -> None:
        super().__init__(capacity)
        self._by_name: Dict[str, Guid] = {}
        # durable name reservation (persist.social.SocialDataAgent): a
        # guild whose members are all OFFLINE has no live entity, but its
        # name must not be claimable by strangers
        self.name_taken = None  # Optional[Callable[[str], bool]]

    @property
    def guilds(self) -> Dict[Guid, GroupInfo]:
        return self.groups

    def create_guild(self, leader: Guid, name: str) -> Optional[Guid]:
        if not name or name in self._by_name:
            return None
        if self.name_taken is not None and self.name_taken(name):
            return None  # dormant durable guild owns the name
        gid = self._create_group(leader, name=name)
        if gid is not None:
            self._by_name[name] = gid
        return gid

    def guild_of(self, member: Guid) -> Optional[GroupInfo]:
        return self.group_of(member)

    def find_by_name(self, name: str) -> Optional[GroupInfo]:
        gid = self._by_name.get(name)
        return self.groups.get(gid) if gid is not None else None

    def _dissolve(self, g: GroupInfo) -> None:
        self._by_name.pop(g.name, None)
        super()._dissolve(g)

    def restore_state(self, data: dict) -> None:
        super().restore_state(data)
        self._by_name = {g.name: gid for gid, g in self.groups.items() if g.name}


# ===================================================================== GM


class GmModule(Module):
    """Chat-command cheats gated by the GMLevel property (NFCGmModule
    parses "/command arg" chat lines)."""

    name = "GmModule"

    def __init__(self, level_module=None, pack=None, min_gm_level: int = 1):
        super().__init__()
        self.level = level_module
        self.pack = pack
        self.min_gm_level = min_gm_level

    def handle_command(self, player: Guid, text: str) -> bool:
        """Returns True if `text` was a GM command this player may run."""
        if not text.startswith("/"):
            return False
        k = self.kernel
        if int(k.get_property(player, "GMLevel")) < self.min_gm_level:
            return False
        parts = text[1:].split()
        if not parts:
            return False
        cmd, args = parts[0].lower(), parts[1:]
        try:
            return self._run(k, player, cmd, args)
        except (ValueError, IndexError):
            return False  # malformed args are not a crash

    def _run(self, k, player: Guid, cmd: str, args: List[str]) -> bool:
        if cmd == "level" and args:
            k.set_property(player, "Level", int(args[0]))
            return True
        if cmd == "gold" and args:
            k.set_property(player, "Gold",
                           int(k.get_property(player, "Gold")) + int(args[0]))
            return True
        if cmd == "exp" and args and self.level is not None:
            self.level.add_exp(player, int(args[0]))
            return True
        if cmd == "item" and args and self.pack is not None:
            count = int(args[1]) if len(args) > 1 else 1
            return self.pack.create_item(player, args[0], count)
        if cmd == "kill" and args:
            target = Guid.parse(args[0])
            if target in k.store.guid_map:
                k.set_property(target, "HP", 0)
                return True
        return False


# ===================================================================== PVP


@dataclasses.dataclass
class MatchTicket:
    player: Guid
    score: int
    queued_at: float
    mode: int = 0  # players only pair within one PVP mode


class PvpMatchModule(Module):
    """Queue pairing by score window (NFCGSPVPMatchModule): join with a
    rating, `execute()`-style matching pairs the closest tickets whose
    scores are within `window` (widening by wait time)."""

    name = "PvpMatchModule"

    def __init__(self, window: int = 100, widen_per_s: int = 50,
                 keep_matches: int = 256) -> None:
        super().__init__()
        self.window = window
        self.widen_per_s = widen_per_s
        self.queue: List[MatchTicket] = []
        # bounded recent-match history (consumers should act on the
        # match_once() return value, not poll this)
        self.matches: Deque[Tuple[Guid, Guid]] = collections.deque(
            maxlen=keep_matches
        )

    def join_queue(self, player: Guid, score: int,
                   now: Optional[float] = None, mode: int = 0) -> bool:
        if any(t.player == player for t in self.queue):
            return False
        self.queue.append(MatchTicket(
            player, int(score),
            _time.monotonic() if now is None else now, int(mode)))
        return True

    def leave_queue(self, player: Guid) -> bool:
        n = len(self.queue)
        self.queue = [t for t in self.queue if t.player != player]
        return len(self.queue) != n

    def match_once(self, now: Optional[float] = None) -> List[Tuple[Guid, Guid]]:
        """Pair greedily by score; each ticket's acceptable window widens
        with wait time.  Returns the new pairs (also kept in .matches)."""
        return [(a.player, b.player)
                for a, b in self.match_once_tickets(now)]

    def match_once_tickets(
        self, now: Optional[float] = None
    ) -> List[Tuple[MatchTicket, MatchTicket]]:
        """match_once, but returning the full tickets — consumers that
        label the match (room mode = the PAIR's queue mode, not the
        triggering request's) need more than the guids."""
        now = _time.monotonic() if now is None else now
        order = sorted(self.queue, key=lambda t: t.score)
        paired: List[Tuple[MatchTicket, MatchTicket]] = []
        used = set()
        for i, a in enumerate(order):
            if id(a) in used:
                continue
            win_a = self.window + self.widen_per_s * int(now - a.queued_at)
            best = None
            for b in order[i + 1:]:
                if id(b) in used or b.mode != a.mode:
                    continue  # only pair within one PVP mode
                gap = b.score - a.score
                win_b = self.window + self.widen_per_s * int(now - b.queued_at)
                if gap <= min(win_a, win_b):
                    best = b
                    break  # sorted: first same-mode candidate is closest
            if best is not None:
                used.add(id(a))
                used.add(id(best))
                paired.append((a, best))
        if paired:
            matched_players = {t.player for pair in paired for t in pair}
            self.queue = [t for t in self.queue
                          if t.player not in matched_players]
            self.matches.extend(
                (a.player, b.player) for a, b in paired
            )
        return paired
